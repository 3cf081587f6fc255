"""SLATE and Slot-Attention pretraining, one optimizer step at a time, in
plain PyTorch (float32, NCHW convolutions).

SLATE (Singh et al., "Illiterate DALL-E Learns to Compose", ICLR 2022) as
OCRL configures it (Yoon et al., ICML 2023, configs/ocr/slate.yaml): a
discrete VAE over 4 x 4 patches whose soft Gumbel sample is decoded back to
the image, a CNN encoder with positional features, slot attention
(Locatello et al., NeurIPS 2020) over its tokens, and a transformer decoder
that predicts the dVAE's token ids from the slots. The loss is the dVAE's
squared error summed over pixels, averaged over the batch, plus the
decoder's cross-entropy summed over tokens, averaged over the batch. With
``use_bcdec`` the model is Slot-Attention's: the same encoder and slot
attention, decoded by a spatial broadcast decoder whose per-slot images
are mixed by a softmax over the slots, trained on the squared error alone.

A step clips every gradient by the inf-norm, then takes Adam (b1 0.9, b2
0.999, eps 1e-8) in three groups: the dVAE at a constant rate, the encoder
side and the decoder side on a linear warm-up and an exponential decay.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .draws import IDS_STREAM, SOFT_STREAM, Draws

LN_EPS = 1e-6
SLOT_EPS = 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# first component of a parameter's name -> its Adam group
GROUP_OF = {"dvae": "dvae", "enc": "sa", "enc_pos": "sa", "slotattn": "sa",
            "slotproj": "sa", "bcdec": "sa", "dictionary": "dec", "bos": "dec",
            "z_pos": "dec", "tfdec": "dec", "out": "dec"}


# -- parameters ---------------------------------------------------------------

def _conv(name: str, cin: int, cout: int, k: int, bias: bool = True) -> list:
    out = [(f"{name}.weight", (cout, cin, k, k), "fan")]
    return out + ([(f"{name}.bias", (cout,), "zero")] if bias else [])


def _linear(name: str, cin: int, cout: int, bias: bool = True) -> list:
    out = [(f"{name}.weight", (cout, cin), "fan")]
    return out + ([(f"{name}.bias", (cout,), "zero")] if bias else [])


def _norm(name: str, d: int) -> list:
    return [(f"{name}.weight", (d,), "one"), (f"{name}.bias", (d,), "zero")]


def param_spec(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter of the model of config ``m``
    (the keys of a configuration file). init: "fan" (uniform with the
    variance 2 / (fan_in + fan_out)), "unit" (uniform, variance 1), "one",
    "zero", "embed" (uniform, variance 1 / d), "slot" (a [1, 1, D]
    vector, uniform, variance 2 / (1 + D))."""
    C, hid, D = m["obs_channels"], m["cnn_hidden_size"], m["slot_size"]
    V, d, mlp = m["vocab_size"], m["d_model"], m["mlp_hidden_size"]
    T = (m["obs_size"] // 4) ** 2
    spec = [("bos", (1, 1, d), "slot")]
    spec += _conv("enc.blocks.0.conv", C, hid, 5) + _conv("enc.blocks.1.conv", hid, hid, 5)
    spec += _conv("enc.blocks.2.conv", hid, hid, 5) + _conv("enc.out", hid, hid, 5)
    spec += _conv("enc_pos.channels_map", 4, hid, 1)
    spec += [("slotattn.slot_mu", (1, 1, D), "slot"), ("slotattn.slot_log_sigma", (1, 1, D), "slot")]
    spec += _norm("slotattn.layer_norm", hid)
    spec += _linear("slotattn.mlp.0", hid, hid) + _linear("slotattn.mlp.2", hid, hid)
    sa = "slotattn.slot_attention"
    spec += _norm(f"{sa}.norm_inputs", hid) + _norm(f"{sa}.norm_slots", D)
    spec += _norm(f"{sa}.norm_mlp", D)
    spec += _linear(f"{sa}.project_q", D, D, False) + _linear(f"{sa}.project_k", hid, D, False)
    spec += _linear(f"{sa}.project_v", hid, D, False)
    spec += _linear(f"{sa}.gru.wi", D, 3 * D) + _linear(f"{sa}.gru.wh", D, 3 * D)
    spec += _linear(f"{sa}.mlp.0", D, mlp) + _linear(f"{sa}.mlp.2", mlp, D)
    if m["use_bcdec"]:
        spec += _conv("bcdec.conv1", D, hid, 5) + _conv("bcdec.rest.0.conv", hid, hid, 5)
        spec += _conv("bcdec.rest.1.conv", hid, hid, 5) + _conv("bcdec.rest.2", hid, C + 1, 3)
        spec += _conv("bcdec.pos_emb.channels_map", 4, D, 1)
    h = 64
    spec += _conv("dvae.encoder.0.conv", C, h, 4)
    for i in range(1, 7):
        spec += _conv(f"dvae.encoder.{i}.conv", h, h, 1)
    spec += _conv("dvae.encoder.7", h, V, 1)
    for i, (cin, cout, k) in enumerate(_DVAE_DECODER(V, h)):
        spec += _conv(f"dvae.decoder_blocks.{i}.conv", cin, cout, k)
    spec += _conv("dvae.decoder_out", h, C, 1)
    spec += _linear("slotproj", D, d, False)
    spec += [("dictionary.weight", (V, d), "embed"), ("z_pos.pe", (1, 1 + T, d), "unit")]
    for b in range(m["num_dec_blocks"]):
        pre = f"tfdec.blocks.{b}"
        for attn in ("self_attn", "encoder_decoder_attn"):
            spec += _norm(f"{pre}.{attn}_layer_norm", d)
            for proj in ("q", "k", "v", "o"):
                spec += _linear(f"{pre}.{attn}.proj_{proj}", d, d, False)
        spec += _norm(f"{pre}.ffn_layer_norm", d)
        spec += _linear(f"{pre}.ffn.fc1", d, 4 * d) + _linear(f"{pre}.ffn.fc2", 4 * d, d)
    spec += _norm("tfdec.layer_norm", d) + _linear("out", d, V, False)
    return spec


def _DVAE_DECODER(V: int, h: int) -> list[tuple[int, int, int]]:
    """(in, out, kernel) of the dVAE decoder's nine conv + ReLU blocks; a
    pixel shuffle by 2 follows blocks 4 and 8."""
    return [(V, h, 1), (h, h, 3), (h, h, 1), (h, h, 1), (h, 4 * h, 1),
            (h, h, 3), (h, h, 1), (h, h, 1), (h, 4 * h, 1)]


# -- layers -------------------------------------------------------------------

def conv(p: dict, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0):
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride, padding)


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def position_grid(size: int, device) -> torch.Tensor:
    """[1, 4, H, W]: ramps falling to the south, rising to the south,
    falling to the east, rising to the east."""
    down = torch.linspace(0, 1, size, device=device)
    up = torch.linspace(1, 0, size, device=device)
    H = W = size
    return torch.stack([up[:, None].expand(H, W), down[:, None].expand(H, W),
                        up[None, :].expand(H, W), down[None, :].expand(H, W)])[None]


def dropout(x: torch.Tensor, rate: float, draws: Draws | None) -> torch.Tensor:
    if draws is None or rate == 0.0:
        return x
    keep = draws.rand(x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


# -- the encoder side -----------------------------------------------------------

def slots_of(p: dict, m: dict, x: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Images [B, C, H, W] in [0, 1] -> slots [B, S, D]."""
    h = x
    for i in range(3):
        h = torch.relu(conv(p, f"enc.blocks.{i}.conv", h, padding=2))
    h = conv(p, "enc.out", h, padding=2)
    h = h + conv(p, "enc_pos.channels_map", position_grid(x.shape[-1], x.device))
    B, C = h.shape[:2]
    tokens = h.permute(0, 2, 3, 1).reshape(B, -1, C)
    tokens = norm(p, "slotattn.layer_norm", tokens)
    tokens = linear(p, "slotattn.mlp.2", torch.relu(linear(p, "slotattn.mlp.0", tokens)))
    S, D = m["num_slots"], m["slot_size"]
    noise = draws.randn((B, S, D))
    slots = p["slotattn.slot_mu"] + torch.exp(p["slotattn.slot_log_sigma"]) * noise
    return slot_attention(p, m, tokens, slots)


def slot_attention(p: dict, m: dict, inputs: torch.Tensor, slots: torch.Tensor):
    """Iterative attention: a softmax over heads x slots for each token,
    renormalised over the tokens (plus epsilon), a GRU update and a
    residual MLP, ``num_iterations`` times."""
    sa = "slotattn.slot_attention"
    B, N, _ = inputs.shape
    S, D, H = m["num_slots"], m["slot_size"], m["num_slot_heads"]
    hd = D // H
    inputs = norm(p, f"{sa}.norm_inputs", inputs)
    k = (linear(p, f"{sa}.project_k", inputs) * hd ** -0.5).reshape(B, N, H, hd)
    v = linear(p, f"{sa}.project_v", inputs).reshape(B, N, H, hd)
    for _ in range(m["num_iterations"]):
        prev = slots
        q = linear(p, f"{sa}.project_q", norm(p, f"{sa}.norm_slots", slots)).reshape(B, S, H, hd)
        logits = torch.einsum("bnhd,bshd->bnhs", k, q).reshape(B, N, H * S)
        attn = torch.softmax(logits, dim=-1).reshape(B, N, H, S) + SLOT_EPS
        attn = attn / attn.sum(dim=1, keepdim=True)
        updates = torch.einsum("bnhs,bnhd->bshd", attn, v).reshape(B, S, D)
        slots = gru(p, f"{sa}.gru", prev.reshape(-1, D), updates.reshape(-1, D)).reshape(B, S, D)
        mlp = linear(p, f"{sa}.mlp.2", torch.relu(
            linear(p, f"{sa}.mlp.0", norm(p, f"{sa}.norm_mlp", slots))))
        slots = slots + mlp
    return slots


def gru(p: dict, name: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """GRU cell, gates in the order reset | update | new."""
    D = h.shape[-1]
    zi, zh = linear(p, f"{name}.wi", x), linear(p, f"{name}.wh", h)
    r = torch.sigmoid(zi[:, :D] + zh[:, :D])
    z = torch.sigmoid(zi[:, D:2 * D] + zh[:, D:2 * D])
    n = torch.tanh(zi[:, 2 * D:] + r * zh[:, 2 * D:])
    return (1.0 - z) * n + z * h


# -- the decoders -----------------------------------------------------------------

def broadcast_decode(p: dict, m: dict, slots: torch.Tensor) -> torch.Tensor:
    """Each slot tiled over the image plus positions, three 5x5 convs and a
    3x3 conv to colour and a mask logit; the slots' images mixed by the
    softmax of their masks over the slots. -> [B, C, H, W]."""
    B, S, D = slots.shape
    size, C = m["obs_size"], m["obs_channels"]
    pos = conv(p, "bcdec.pos_emb.channels_map", position_grid(size, slots.device))
    x = slots.reshape(B * S, D, 1, 1) + pos
    x = torch.relu(conv(p, "bcdec.conv1", x, padding=2))
    x = torch.relu(conv(p, "bcdec.rest.0.conv", x, padding=2))
    x = torch.relu(conv(p, "bcdec.rest.1.conv", x, padding=2))
    x = conv(p, "bcdec.rest.2", x, padding=1).reshape(B, S, C + 1, size, size)
    masks = torch.softmax(x[:, :, C:], dim=1)
    return (x[:, :, :C] * masks).sum(1)


def dvae_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(conv(p, "dvae.encoder.0.conv", x, stride=4))
    for i in range(1, 7):
        h = torch.relu(conv(p, f"dvae.encoder.{i}.conv", h))
    return conv(p, "dvae.encoder.7", h)


def dvae_decode(p: dict, z: torch.Tensor) -> torch.Tensor:
    h = z
    for i in range(9):
        pad = 1 if p[f"dvae.decoder_blocks.{i}.conv.weight"].shape[-1] == 3 else 0
        h = torch.relu(conv(p, f"dvae.decoder_blocks.{i}.conv", h, padding=pad))
        if i in (4, 8):
            h = F.pixel_shuffle(h, 2)
    return conv(p, "dvae.decoder_out", h)


def attention(p: dict, name: str, heads: int, q_in, kv_in, causal: bool, rate: float,
              draws: Draws | None) -> torch.Tensor:
    B, T, d = q_in.shape
    hd = d // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

    q = split(linear(p, f"{name}.proj_q", q_in)) * hd ** -0.5
    k, v = split(linear(p, f"{name}.proj_k", kv_in)), split(linear(p, f"{name}.proj_v", kv_in))
    w = q @ k.transpose(-1, -2)
    if causal:
        cut = torch.ones(T, T, dtype=torch.bool, device=w.device).triu(1)
        w = w.masked_fill(cut, float("-inf"))
    w = dropout(torch.softmax(w, dim=-1), rate, draws)
    out = (w @ v).transpose(1, 2).reshape(B, T, d)
    return dropout(linear(p, f"{name}.proj_o", out), rate, draws)


def decoder_logits(p: dict, m: dict, slots: torch.Tensor, ids: torch.Tensor,
                   draws: Draws | None) -> torch.Tensor:
    """Next-token logits [B, T, V] of the pre-LN decoder fed bos and the
    tokens before each position, attending to the projected slots."""
    rate, heads = m["dropout"], m["num_dec_heads"]
    B = ids.shape[0]
    emb = torch.cat([p["bos"].expand(B, 1, -1), F.embedding(ids, p["dictionary.weight"])], 1)
    x = dropout(emb + p["z_pos.pe"][:, :emb.shape[1]], rate, draws)[:, :-1]
    memory = linear(p, "slotproj", slots)
    for b in range(m["num_dec_blocks"]):
        pre = f"tfdec.blocks.{b}"
        if b == 0:
            x = norm(p, f"{pre}.self_attn_layer_norm", x)
            x = x + attention(p, f"{pre}.self_attn", heads, x, x, True, rate, draws)
        else:
            n = norm(p, f"{pre}.self_attn_layer_norm", x)
            x = x + attention(p, f"{pre}.self_attn", heads, n, n, True, rate, draws)
        n = norm(p, f"{pre}.encoder_decoder_attn_layer_norm", x)
        x = x + attention(p, f"{pre}.encoder_decoder_attn", heads, n, memory, False, rate, draws)
        n = norm(p, f"{pre}.ffn_layer_norm", x)
        x = x + dropout(linear(p, f"{pre}.ffn.fc2", torch.relu(linear(p, f"{pre}.ffn.fc1", n))),
                        rate, draws)
    return linear(p, "out", norm(p, "tfdec.layer_norm", x))


# -- the loss ---------------------------------------------------------------------

def tau_at(m: dict, step: int) -> float:
    """Cosine from tau_start to tau_final over tau_steps."""
    if step >= m["tau_steps"]:
        return m["tau_final"]
    a, b = 0.5 * (m["tau_start"] - m["tau_final"]), 0.5 * (m["tau_start"] + m["tau_final"])
    return a * math.cos(math.pi * step / m["tau_steps"]) + b


def loss(p: dict, m: dict, obs: torch.Tensor, step: int, draws: Draws,
         rows: int | None = None) -> torch.Tensor:
    """The training loss of uint8 images [B, H, W, C] at ``step``. ``rows``
    keeps only the first rows in every mean (a fault to plant: the batch
    cut short after the draws were made)."""
    x = obs.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    B = x.shape[0]
    keep = B if rows is None else rows
    if m["use_bcdec"]:
        recon = broadcast_decode(p, m, slots_of(p, m, x, draws))
        return ((x - recon)[:keep] ** 2).sum() / keep
    logits = dvae_logits(p, x)
    V, h, w = logits.shape[1:]
    flat = logits.permute(0, 2, 3, 1).reshape(-1, V)
    tau = tau_at(m, step)
    if m["hard"]:
        g = draws.exponential_gumbel(flat.shape)
        soft = torch.softmax((flat + g) / tau, dim=-1)
        z = F.one_hot(soft.argmax(-1), V).to(soft.dtype) - soft.detach() + soft
    else:
        z = torch.softmax((flat + draws.gumbel(*flat.shape, SOFT_STREAM)) / tau, dim=-1)
    ids = torch.argmax(flat.detach() + draws.gumbel(*flat.shape, IDS_STREAM), dim=-1)
    ids = ids.reshape(B, h * w)
    slots = slots_of(p, m, x, draws)
    recon = dvae_decode(p, z.reshape(B, h, w, V).permute(0, 3, 1, 2))
    mse = ((x - recon)[:keep] ** 2).sum() / keep
    logp = torch.log_softmax(decoder_logits(p, m, slots, ids, draws), dim=-1)
    ce = -logp.gather(-1, ids[..., None])[..., 0][:keep].sum(-1).mean()
    return mse + ce


# -- the optimizer ----------------------------------------------------------------

def learning_rate(m: dict, group: str, count: int) -> float:
    """The rate of a group at Adam's count (0 at the first update)."""
    if group == "dvae":
        return m["lr_dvae"]
    base = m["lr_enc"] if group == "sa" else m["lr_dec"]
    warm = m["lr_warmup_steps"]
    ramp = 1.0 if count >= warm else (count + 1) / warm
    return base * ramp * 2.0 ** (-count / m["lr_half_life"])


class Trainer:
    """Parameters, their Adam moments and the draws of one training run."""

    def __init__(self, m: dict, params: dict, seed: int, device):
        self.m = m
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.draws = Draws(seed, device)

    def step(self, obs: torch.Tensor, step: int, rows: int | None = None):
        """One step; returns (loss, the clipped gradients Adam took)."""
        for v in self.p.values():
            v.grad = None
        value = loss(self.p, self.m, obs, step, self.draws, rows)
        value.backward()
        grads = {k: v.grad for k, v in self.p.items() if v.grad is not None}
        total = max(float(g.abs().max()) for g in grads.values())
        scale = min(1.0, self.m["clip"] / (total + 1e-6))
        grads = {k: g * scale for k, g in grads.items()}
        t = self.count + 1
        with torch.no_grad():
            for k, g in grads.items():
                lr = learning_rate(self.m, GROUP_OF[k.split(".")[0]], self.count)
                self.mu[k] = ADAM_B1 * self.mu[k] + (1 - ADAM_B1) * g
                self.nu[k] = ADAM_B2 * self.nu[k] + (1 - ADAM_B2) * g * g
                mhat = self.mu[k] / (1 - ADAM_B1 ** t)
                vhat = self.nu[k] / (1 - ADAM_B2 ** t)
                self.p[k] -= lr * mhat / (vhat.sqrt() + ADAM_EPS)
        self.count = t
        return float(value.detach()), grads
