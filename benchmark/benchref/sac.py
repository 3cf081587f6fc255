"""Soft Actor-Critic's update (Haarnoja et al., 2018, as Stable-Baselines3
1.5 computes it and OCRL trains it end to end) on SLATE's slots, in plain
PyTorch.

The features are SLATE's slots (the CNN encoder and slot attention of
``benchref.ocr``) pooled by a one-layer post-norm transformer encoder (a
linear map to d, a learned CLS token in front, 8-head self-attention with
biases, LayerNorm eps 1e-5, a ReLU feed-forward of 2048) read at the CLS
token. The actor is an MLP to a squashed Gaussian's mean and log-std
(clipped to [-20, 2]); two critics are MLPs of the features and the
action. One update: the target from the next observations through the
online and the target networks, the critics' squared error back through
the whole extractor, the actor's loss on the same features detached,
Adam (eps 1e-5) for each, then the Polyak average of every parameter into
the target. The entropy coefficient is fixed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .draws import Draws
from .ocr import _linear, _norm, linear, norm, param_spec as ocr_spec, slot_attention

SERVING = ("bos", "enc.", "enc_pos.", "slotattn.")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def param_spec(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of the policy's parameters: the OCR's serving
    part, the pooling, the actor and the two critics."""
    spec = [(f"ocr_module.{n}", s, i) for n, s, i in ocr_spec(m) if n.startswith(SERVING)]
    D, d, A = m["slot_size"], m["pool_d_model"], m["action_dim"]
    core, ff = "pooling_module.core", m["pool_feedforward"]
    spec += [(f"{core}.cls_token", (d,), "embed")] + _linear(f"{core}.proj", D, d)
    for i in range(m["pool_num_layers"]):
        layer = f"{core}.layers.{i}"
        for proj in ("query", "key", "value", "out"):
            spec += _linear(f"{layer}.attn.{proj}", d, d)
        spec += _norm(f"{layer}.norm1", d)
        spec += _linear(f"{layer}.linear1", d, ff) + _linear(f"{layer}.linear2", ff, d)
        spec += _norm(f"{layer}.norm2", d)
    for head, d_in, d_out in (("actor", d, 2 * A), ("q1", d + A, 1), ("q2", d + A, 1)):
        for j, width in enumerate(m["net_arch"]):
            spec += _linear(f"{head}_{j}", d_in, width)
            d_in = width
        spec += _linear(f"{head}_out", d_in, d_out)
    return spec


def features(p: dict, m: dict, obs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Images [B, H, W, C] in [0, 1] and the initial slots' normals ->
    pooled features [B, d]."""
    ocr = {k[len("ocr_module."):]: v for k, v in p.items() if k.startswith("ocr_module.")}
    x = obs.permute(0, 3, 1, 2)
    h = x
    for i in range(3):
        h = torch.relu(F.conv2d(h, ocr[f"enc.blocks.{i}.conv.weight"],
                                ocr[f"enc.blocks.{i}.conv.bias"], padding=2))
    h = F.conv2d(h, ocr["enc.out.weight"], ocr["enc.out.bias"], padding=2)
    from .ocr import position_grid
    h = h + F.conv2d(position_grid(x.shape[-1], x.device), ocr["enc_pos.channels_map.weight"],
                     ocr["enc_pos.channels_map.bias"])
    B, C = h.shape[:2]
    tokens = norm(ocr, "slotattn.layer_norm", h.permute(0, 2, 3, 1).reshape(B, -1, C))
    tokens = linear(ocr, "slotattn.mlp.2", torch.relu(linear(ocr, "slotattn.mlp.0", tokens)))
    slots = ocr["slotattn.slot_mu"] + torch.exp(ocr["slotattn.slot_log_sigma"]) * noise
    slots = slot_attention(ocr, m, tokens, slots)
    return pool(p, m, slots)


def pool(p: dict, m: dict, slots: torch.Tensor) -> torch.Tensor:
    core = "pooling_module.core"
    B = slots.shape[0]
    x = linear(p, f"{core}.proj", slots)
    x = torch.cat([p[f"{core}.cls_token"].expand(B, 1, -1), x], dim=1)
    heads = m["pool_nhead"]
    for i in range(m["pool_num_layers"]):
        layer = f"{core}.layers.{i}"
        L, d = x.shape[1], x.shape[2]
        hd = d // heads
        q = linear(p, f"{layer}.attn.query", x).view(B, L, heads, hd) / math.sqrt(hd)
        k = linear(p, f"{layer}.attn.key", x).view(B, L, heads, hd)
        v = linear(p, f"{layer}.attn.value", x).view(B, L, heads, hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        attn = linear(p, f"{layer}.attn.out", torch.einsum("bhqk,bkhd->bqhd", w, v)
                      .reshape(B, L, d))
        x = F.layer_norm(x + attn, (d,), p[f"{layer}.norm1.weight"], p[f"{layer}.norm1.bias"],
                         1e-5)
        ff = linear(p, f"{layer}.linear2", torch.relu(linear(p, f"{layer}.linear1", x)))
        x = F.layer_norm(x + ff, (d,), p[f"{layer}.norm2.weight"], p[f"{layer}.norm2.bias"], 1e-5)
    return x[:, 0]


def mlp(p: dict, m: dict, head: str, x: torch.Tensor) -> torch.Tensor:
    for j in range(len(m["net_arch"])):
        x = torch.relu(linear(p, f"{head}_{j}", x))
    return linear(p, f"{head}_out", x)


def actor(p: dict, m: dict, feats: torch.Tensor):
    mu, log_std = mlp(p, m, "actor", feats).chunk(2, dim=-1)
    return mu, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)


def critics(p: dict, m: dict, feats: torch.Tensor, action: torch.Tensor):
    x = torch.cat([feats, action], dim=-1)
    return mlp(p, m, "q1", x)[..., 0], mlp(p, m, "q2", x)[..., 0]


def squashed(mu: torch.Tensor, log_std: torch.Tensor, eps: torch.Tensor):
    """tanh of a Gaussian sample and its log-probability with the tanh
    correction log(1 - a^2 + 1e-6)."""
    std = torch.exp(log_std)
    u = mu + std * eps
    a = torch.tanh(u)
    logp = -0.5 * (((u - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))
    return a, logp.sum(-1) - torch.log(1 - a ** 2 + 1e-6).sum(-1)


class Trainer:
    """The policy's parameters, its target copy, both Adams and the draws."""

    def __init__(self, m: dict, params: dict, seed: int, device):
        self.m = m
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.target = {k: v.detach().clone() for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.draws = Draws(seed, device)

    def skip_act(self, envs: int) -> None:
        """The draws of a policy call on ``envs`` observations, unused."""
        self.draws.randn((envs, self.m["num_slots"], self.m["slot_size"]))
        self.draws.randn((envs, self.m["action_dim"]))

    def step(self, batch: dict, rows: int | None = None):
        """One update on a sampled batch (numpy: uint8 images, actions,
        rewards, dones); returns ([critic loss, actor loss], the gradients
        Adam took). ``rows`` keeps only the first rows in every mean."""
        m, p = self.m, self.p
        dev = self.draws.device
        obs = torch.from_numpy(batch["obs"]).to(dev).to(torch.float32) / 255.0
        next_obs = torch.from_numpy(batch["next_obs"]).to(dev).to(torch.float32) / 255.0
        actions = torch.from_numpy(batch["actions"]).to(dev)
        rewards = torch.from_numpy(batch["rewards"]).to(dev)
        dones = torch.from_numpy(batch["dones"]).to(dev)
        B = obs.shape[0]
        keep = B if rows is None else rows
        slot_shape = (B, m["num_slots"], m["slot_size"])
        slots_next, slots = self.draws.randn(slot_shape), self.draws.randn(slot_shape)
        eps_next = self.draws.randn((B, m["action_dim"]))
        eps_pi = self.draws.randn((B, m["action_dim"]))
        alpha = m["ent_coef"]
        with torch.no_grad():
            online = {k: v.detach() for k, v in p.items()}
            a_next, logp_next = squashed(*actor(online, m, features(online, m, next_obs,
                                                                    slots_next)), eps_next)
            tq1, tq2 = critics(self.target, m, features(self.target, m, next_obs, slots_next),
                               a_next)
            y = rewards + m["gamma"] * (1 - dones) * (torch.minimum(tq1, tq2)
                                                      - alpha * logp_next)
        for v in p.values():
            v.grad = None
        feats = features(p, m, obs, slots)
        q1, q2 = critics(p, m, feats, actions)
        critic_loss = 0.5 * (((q1 - y)[:keep] ** 2).mean() + ((q2 - y)[:keep] ** 2).mean())
        critic_names = [k for k in p if not k.startswith("actor_")]
        grads = dict(zip(critic_names, torch.autograd.grad(
            critic_loss, [p[k] for k in critic_names], allow_unused=True)))
        fd = feats.detach()
        a_pi, logp_pi = squashed(*actor(p, m, fd), eps_pi)
        q1_pi, q2_pi = critics(p, m, fd, a_pi)
        actor_loss = (alpha * logp_pi - torch.minimum(q1_pi, q2_pi))[:keep].mean()
        actor_names = [k for k in p if k.startswith("actor_")]
        grads.update(zip(actor_names, torch.autograd.grad(
            actor_loss, [p[k] for k in actor_names], allow_unused=True)))
        grads = {k: g for k, g in grads.items() if g is not None}
        t = self.count + 1
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = ADAM_B1 * self.mu[k] + (1 - ADAM_B1) * g
                self.nu[k] = ADAM_B2 * self.nu[k] + (1 - ADAM_B2) * g * g
                mhat = self.mu[k] / (1 - ADAM_B1 ** t)
                vhat = self.nu[k] / (1 - ADAM_B2 ** t)
                p[k] -= m["learning_rate"] * mhat / (vhat.sqrt() + ADAM_EPS)
            tau = m["tau"]
            for k in self.target:
                self.target[k] = (1 - tau) * self.target[k] + tau * p[k].detach()
        self.count = t
        return [float(critic_loss.detach()), float(actor_loss.detach())], grads
