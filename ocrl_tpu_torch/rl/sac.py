"""Soft Actor-Critic (counterpart of ocrl_tpu/rl/sac.py:54-400), for the
continuous-action CausalWorld reach tasks.

SB3 1.5 semantics, as the JAX package keeps them: a squashed-Gaussian
actor, twin Q critics with Polyak-averaged targets (``tau``, after every
gradient step), a fixed or tuned entropy coefficient (``"auto"`` /
``"auto_<init>"``: target entropy -dim(A)), a uniform replay buffer,
``learning_starts`` steps of uniform random actions, and ``gradient_steps``
updates every ``train_freq`` vector steps once ``num_timesteps`` has reached
``learning_starts`` (checked after the step, so the first update follows
the last random step).

The two optimizers are optax's Adam (eps 1e-5) written out
(``OptaxChain``, no clip): the actor's over ``actor_*``, the critic's over
``q1_*``, ``q2_*`` and, trained end to end, the extractor (OCR and
pooling). With the OCR frozen the whole extractor is frozen, the pooling
too, as JAX labels it (ocrl_tpu/rl/sac.py:195-202): no optimizer state, no
gradient, and its passes run without autograd. The actor loss takes the
critic loss's features detached: JAX computes them twice with the same
noise and takes only the actor's parameters' gradient of that loss, so the
numbers are the same with one encoder pass fewer. An end-to-end update runs
the encoder three times (``obs`` with a graph, ``next_obs`` with the
parameters and with the target parameters, the two on the same slot
noise) and backward once. The target network is a second copy of every
parameter, the OCR's included.

Random numbers: uniform random actions and the buffer's indices from a
numpy ``default_rng(seed)``, as JAX; slot noise and the Gaussians of the
samples from the algorithm's ``torch.Generator`` on its device, or given
(``noise=``: ``slots`` / ``eps`` for a policy call; ``slots``,
``slots_next``, ``eps_next``, ``eps_pi`` for an update). Observations stay
uint8 in the host buffer (``np.empty``: pages are touched as they fill) and
become float32 / 255 on the device after the upload. A profiler's trace
shows the phases of a vector step (``utils.tracing``): ``ocrl.sample``,
``ocrl.upload``, ``ocrl.update`` around its ``ocrl.optimizer``, and the vec
env's ``ocrl.env_wait``.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..config import SACConfig
from ..device import resolve_device
from ..utils import tracing
from .ac_nets import _dense
from .ppo import OnPolicyAlgo, OptaxChain

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
ADAM_EPS = 1e-5


class SACPolicy(nn.Module):
    """OCR + pooling + squashed-Gaussian actor + twin Q critics
    (ocrl_tpu/rl/sac.py:54-97). The heads are JAX's top-level layers:
    ``actor_{i}``, ``actor_out`` (2 x action_dim), ``q1_*`` and ``q2_*``
    (1), relu between."""

    def __init__(self, ocr_module: nn.Module, pooling_module: nn.Module, features_dim: int,
                 action_dim: int, net_arch: tuple[int, ...] = (256, 256),
                 freeze_ocr: bool = False):
        super().__init__()
        self.ocr_module = ocr_module
        self.pooling_module = pooling_module
        self.action_dim = action_dim
        self.net_arch = tuple(net_arch)
        self.freeze_ocr = freeze_ocr
        for name, in_dim, out_dim in (("actor", features_dim, 2 * action_dim),
                                      ("q1", features_dim + action_dim, 1),
                                      ("q2", features_dim + action_dim, 1)):
            for i, h in enumerate(self.net_arch):
                setattr(self, f"{name}_{i}", _dense(in_dim, h, None))
                in_dim = h
            setattr(self, f"{name}_out", _dense(in_dim, out_dim, None))

    def noise_shape(self, B: int) -> tuple[int, ...] | None:
        """The shape of the OCR's noise for B observations, None where it
        draws nothing."""
        shape_fn = getattr(self.ocr_module, "noise_shape", None)
        return shape_fn(B) if shape_fn is not None else None

    def extract(self, obs: torch.Tensor, noise: torch.Tensor | None = None) -> torch.Tensor:
        """obs in [0, 1] -> pooled features, ``noise`` the OCR's draws; a
        frozen OCR runs without autograd (JAX's stop_gradient)."""
        if self.freeze_ocr:
            with torch.no_grad():
                rep = self.ocr_module(obs, noise=noise)
        else:
            rep = self.ocr_module(obs, noise=noise)
        return self.pooling_module(rep)

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.net_arch)):
            x = torch.relu(getattr(self, f"{name}_{i}")(x))
        return getattr(self, f"{name}_out")(x)

    def actor(self, features: torch.Tensor):
        """-> (mu, log_std clipped to [-20, 2]), each [B, action_dim]."""
        mu, log_std = self._mlp("actor", features).chunk(2, dim=-1)
        return mu, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)

    def critics(self, features: torch.Tensor, action: torch.Tensor):
        """-> (q1 [B], q2 [B])."""
        x = torch.cat([features, action], dim=-1)
        return self._mlp("q1", x)[..., 0], self._mlp("q2", x)[..., 0]


def sample_squashed(mu: torch.Tensor, log_std: torch.Tensor, eps: torch.Tensor):
    """a = tanh(u), u = mu + exp(log_std) * eps; -> (a, log-probability)
    with SB3's tanh correction (the sum of log(1 - a^2 + 1e-6))."""
    std = torch.exp(log_std)
    u = mu + std * eps
    a = torch.tanh(u)
    logp = -0.5 * (((u - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))
    logp = logp.sum(-1) - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a, logp


class ReplayBuffer:
    """Uniform ring buffer on the host (ocrl_tpu/rl/sac.py:114-151); image
    observations stored uint8, state observations float32. ``sample``
    returns the rows as stored: ``SAC.upload`` makes the observations
    float32 / 255 on the device, which gives JAX's bits."""

    def __init__(self, capacity: int, obs_shape, action_dim: int, is_image_obs: bool):
        self.capacity = capacity
        self.is_image_obs = is_image_obs
        obs_dtype = np.uint8 if is_image_obs else np.float32
        self.obs = np.empty((capacity,) + tuple(obs_shape), obs_dtype)
        self.next_obs = np.empty((capacity,) + tuple(obs_shape), obs_dtype)
        self.actions = np.empty((capacity, action_dim), np.float32)
        self.rewards = np.empty((capacity,), np.float32)
        self.dones = np.empty((capacity,), np.float32)
        self.pos = 0
        self.full = False

    def add(self, obs, next_obs, action, reward, done) -> None:
        n = len(obs)
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = action.reshape(n, -1)
        self.rewards[idx] = reward
        self.dones[idx] = done
        self.pos = int((self.pos + n) % self.capacity)
        self.full = self.full or self.pos < n

    def __len__(self) -> int:
        return self.capacity if self.full else self.pos

    def sample(self, batch_size: int, rng: np.random.Generator) -> dict:
        idx = rng.integers(0, len(self), size=batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx]}


class SAC:
    def __init__(self, policy: SACPolicy, obs_shape, is_image_obs: bool = True,
                 num_envs: int = 1, config: SACConfig | None = None, seed: int = 0,
                 action_low=-1.0, action_high=1.0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = config = config or SACConfig()
        self.policy = policy.to(self.device).eval()
        self.target = copy.deepcopy(self.policy).requires_grad_(False)
        self.obs_shape = tuple(obs_shape)
        self.is_image_obs = is_image_obs
        self.num_envs = num_envs
        self.action_dim = policy.action_dim
        self.action_low = np.asarray(action_low, np.float32)
        self.action_high = np.asarray(action_high, np.float32)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)

        ent = config.ent_coef
        self.auto_alpha = isinstance(ent, str) and ent.startswith("auto")
        init_alpha = (float(ent.split("_", 1)[1]) if "_" in ent else 1.0) \
            if self.auto_alpha else float(ent)
        dtype = next(self.policy.parameters()).dtype
        self.log_alpha = torch.tensor(float(np.log(init_alpha)), dtype=dtype,
                                      device=self.device)
        self.target_entropy = -float(self.action_dim) if self.auto_alpha else 0.0
        self.alpha_optimizer = OptaxChain([self.log_alpha], "adam", config.learning_rate,
                                          None, ADAM_EPS) if self.auto_alpha else None
        self._new_optimizers()
        self.num_timesteps = 0
        self.buffer: ReplayBuffer | None = None
        self.last_iteration: dict = {}
        self.totals = {"random_steps": 0, "random_s": 0.0, "policy_steps": 0,
                       "policy_s": 0.0, "updates": 0, "update_s": 0.0}

    def group_names(self) -> dict[str, list[str]]:
        """The parameter names of each optimizer: ``actor``, ``critic`` (the
        extractor too unless frozen) and ``frozen`` (no optimizer)."""
        groups = {"actor": [], "critic": [], "frozen": []}
        for name, _ in self.policy.named_parameters():
            if name.startswith("actor_"):
                groups["actor"].append(name)
            elif name.startswith(("q1_", "q2_")) or not self.policy.freeze_ocr:
                groups["critic"].append(name)
            else:
                groups["frozen"].append(name)
        return groups

    def _new_optimizers(self) -> None:
        """Fresh Adam states for the actor and the critic."""
        params = dict(self.policy.named_parameters())
        groups = self.group_names()
        self.optimizers = {g: OptaxChain([params[n] for n in groups[g]], "adam",
                                         self.cfg.learning_rate, None, ADAM_EPS)
                           for g in ("actor", "critic")}
        self.param_names = {g: groups[g] for g in ("actor", "critic")}

    # -- noise -------------------------------------------------------------------

    def _slot_noise(self, B: int) -> torch.Tensor | None:
        shape = self.policy.noise_shape(B)
        if shape is None:
            return None
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _normal(self, B: int) -> torch.Tensor:
        return torch.randn((B, self.action_dim), generator=self.generator, device=self.device)

    @staticmethod
    def _given(noise: dict | None, key: str, draw):
        value = None if noise is None else noise.get(key)
        return draw() if value is None else value

    # -- acting ------------------------------------------------------------------

    prep = OnPolicyAlgo.prep       # raw to the device, float32 there, / 255 for images

    @torch.no_grad()
    def act(self, obs, deterministic: bool = False, noise: dict | None = None) -> torch.Tensor:
        """Raw actions in [-1, 1], [B, action_dim], on the device: tanh of
        the mean, or a squashed sample (ocrl_tpu/rl/sac.py:227-234)."""
        x = self.prep(obs)
        B = x.shape[0]
        features = self.policy.extract(x, self._given(noise, "slots", lambda: self._slot_noise(B)))
        mu, log_std = self.policy.actor(features)
        if deterministic:
            return torch.tanh(mu)
        eps = self._given(noise, "eps", lambda: self._normal(B))
        return sample_squashed(mu, log_std, eps)[0]

    def scale_action(self, a: np.ndarray) -> np.ndarray:
        """[-1, 1] -> [low, high] in float32, as JAX (not the identity on
        [-1, 1] in float32)."""
        return self.action_low + 0.5 * (a + 1.0) * (self.action_high - self.action_low)

    def predict(self, obs, deterministic: bool = False, noise: dict | None = None) -> np.ndarray:
        """Scaled actions for one observation or a batch, as numpy."""
        obs = np.asarray(obs)
        squeeze = obs.ndim == len(self.obs_shape)
        if squeeze:
            obs = obs[None]
        a = self.scale_action(self.act(obs, deterministic, noise).cpu().numpy())
        return a[0] if squeeze else a

    # -- the update --------------------------------------------------------------

    def upload(self, batch: dict) -> dict:
        """A sampled batch on the device, observations float32 (/ 255)."""
        with tracing.span("upload"):
            data = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}
            for key in ("obs", "next_obs"):
                data[key] = data[key].to(torch.float32)
                if self.is_image_obs:
                    data[key] = data[key] / 255.0
        return data

    @staticmethod
    def _features(module: SACPolicy, obs: torch.Tensor, noise, grad: bool):
        with torch.set_grad_enabled(grad):
            return module.extract(obs, noise)

    def update(self, data: dict, noise: dict | None = None) -> dict:
        """One gradient step on an uploaded batch (ocrl_tpu/rl/sac.py:236-318):
        the critic and actor losses, both Adam steps, the Polyak update of
        the target, then, with ``auto``, the entropy coefficient's step.
        Returns the metrics as device tensors."""
        with tracing.span("update"):
            return self._update(data, noise)

    def _update(self, data: dict, noise: dict | None) -> dict:
        cfg, policy = self.cfg, self.policy
        B = data["obs"].shape[0]
        slots_next = self._given(noise, "slots_next", lambda: self._slot_noise(B))
        slots = self._given(noise, "slots", lambda: self._slot_noise(B))
        eps_next = self._given(noise, "eps_next", lambda: self._normal(B))
        eps_pi = self._given(noise, "eps_pi", lambda: self._normal(B))
        alpha = torch.exp(self.log_alpha)

        with torch.no_grad():
            feats_next = self._features(policy, data["next_obs"], slots_next, False)
            a_next, logp_next = sample_squashed(*policy.actor(feats_next), eps_next)
            tfeats_next = self._features(self.target, data["next_obs"], slots_next, False)
            tq1, tq2 = self.target.critics(tfeats_next, a_next)
            target_q = torch.minimum(tq1, tq2) - alpha * logp_next
            target = data["rewards"] + cfg.gamma * (1 - data["dones"]) * target_q

        params = dict(policy.named_parameters())
        critic_params = [params[n] for n in self.param_names["critic"]]
        actor_params = [params[n] for n in self.param_names["actor"]]
        with torch.enable_grad():
            feats = self._features(policy, data["obs"], slots, not policy.freeze_ocr)
            q1, q2 = policy.critics(feats, data["actions"])
            critic_loss = 0.5 * (((q1 - target) ** 2).mean() + ((q2 - target) ** 2).mean())
            critic_grads = torch.autograd.grad(critic_loss, critic_params, allow_unused=True)

            feats = feats.detach()
            a_pi, logp_pi = sample_squashed(*policy.actor(feats), eps_pi)
            q1_pi, q2_pi = policy.critics(feats, a_pi)
            actor_loss = (alpha * logp_pi - torch.minimum(q1_pi, q2_pi)).mean()
            actor_grads = torch.autograd.grad(actor_loss, actor_params, allow_unused=True)

        metrics = {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss.detach(),
                   "alpha": alpha, "entropy": -logp_pi.detach().mean()}
        with tracing.span("optimizer"):
            self.optimizers["critic"].step(critic_grads)
            self.optimizers["actor"].step(actor_grads)
            self.polyak()
            if self.auto_alpha:
                log_alpha = self.log_alpha.detach().requires_grad_(True)
                with torch.enable_grad():
                    alpha_loss = -(log_alpha * (logp_pi.detach() + self.target_entropy)).mean()
                    (alpha_grad,) = torch.autograd.grad(alpha_loss, log_alpha)
                self.alpha_optimizer.step([alpha_grad])
                metrics["alpha_loss"] = alpha_loss.detach()
        return metrics

    @torch.no_grad()
    def polyak(self) -> None:
        """target = (1 - tau) * target + tau * online, each product rounded
        to float32 before the sum, as JAX's tree map."""
        targets = list(self.target.parameters())
        torch._foreach_mul_(targets, 1 - self.cfg.tau)
        torch._foreach_add_(targets, torch._foreach_mul(list(self.policy.parameters()),
                                                        self.cfg.tau))

    # -- learning ----------------------------------------------------------------

    def learn(self, vec_env, total_timesteps: int,
              iteration_callback: Optional[Callable] = None,
              step_callback: Optional[Callable] = None):
        """Steps and updates until ``total_timesteps`` env steps
        (ocrl_tpu/rl/sac.py:337-385), into a fresh buffer (kept as
        ``self.buffer``). ``iteration_callback(self, metrics, ep_infos)``
        after each vector step that updated; seconds and counts of the
        random steps, the policy steps and the updates add up in
        ``totals``, the last ones land in ``last_iteration``."""
        cfg = self.cfg
        E = vec_env.num_envs
        self.buffer = buffer = ReplayBuffer(cfg.buffer_size, self.obs_shape, self.action_dim,
                                            self.is_image_obs)
        obs = vec_env.reset()
        vec_steps = 0
        while self.num_timesteps < total_timesteps:
            t0 = time.perf_counter()
            random = self.num_timesteps < cfg.learning_starts
            if random:
                raw = self.np_rng.uniform(-1, 1, size=(E, self.action_dim)).astype(np.float32)
            else:
                raw = self.act(obs).cpu().numpy()
            next_obs, rewards, dones, infos = vec_env.step(self.scale_action(raw))
            stored_next = np.array(next_obs)     # the true last obs of a finished episode
            ep_infos = []
            for i, info in enumerate(infos):
                if "terminal_observation" in info:
                    stored_next[i] = info["terminal_observation"]
                    ep_infos.append(info)
            buffer.add(obs, stored_next, raw, rewards, dones)
            obs = next_obs
            self.num_timesteps += E
            vec_steps += 1
            step_s = time.perf_counter() - t0
            kind = "random" if random else "policy"
            self.totals[f"{kind}_steps"] += 1
            self.totals[f"{kind}_s"] += step_s
            if step_callback is not None:
                step_callback(self)

            if self.num_timesteps >= cfg.learning_starts and vec_steps % cfg.train_freq == 0:
                t1 = time.perf_counter()
                for _ in range(cfg.gradient_steps):
                    with tracing.span("sample"):
                        batch = buffer.sample(min(cfg.batch_size, len(buffer)), self.np_rng)
                    metrics = self.update(self.upload(batch))
                host = {k: float(v) for k, v in metrics.items()}
                update_s = time.perf_counter() - t1
                self.totals["updates"] += cfg.gradient_steps
                self.totals["update_s"] += update_s
                self.last_iteration.update(step_s=step_s, update_s=update_s,
                                           updates=cfg.gradient_steps)
                if iteration_callback is not None:
                    iteration_callback(self, host, ep_infos)
        return self

    # -- persistence -------------------------------------------------------------

    def save(self) -> dict:
        """The state in memory (ocrl_tpu/rl/sac.py:388-393)."""
        return {"policy_params": {k: v.clone() for k, v in self.policy.state_dict().items()},
                "target_params": {k: v.clone() for k, v in self.target.state_dict().items()},
                "opt_state": {g: opt.state_dict() for g, opt in self.optimizers.items()},
                "log_alpha": self.log_alpha.clone(),
                "num_timesteps": self.num_timesteps}

    def load(self, ckpt: dict) -> None:
        """``save``'s inverse; a state without ``target_params`` copies the
        parameters into the target, as JAX's ``load``."""
        self.policy.load_state_dict(ckpt["policy_params"])
        self.target.load_state_dict(ckpt.get("target_params", ckpt["policy_params"]))
        for g, state in ckpt.get("opt_state", {}).items():
            self.optimizers[g].load_state_dict(state)
        if "log_alpha" in ckpt:
            self.log_alpha.copy_(torch.as_tensor(ckpt["log_alpha"]))
        self.num_timesteps = int(ckpt.get("num_timesteps", 0))
