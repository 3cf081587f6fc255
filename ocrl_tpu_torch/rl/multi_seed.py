"""Vmapped multi-seed PPO (counterpart of ocrl_tpu/rl/multi_seed.py:39-706):
S seeds trained as one batched computation.

Seed i's parameters are those of the policy built from ``seeds[i]``,
stacked on a leading axis (``self.params``: name -> [S, ...]); one module
(the first policy) gives the structure, and every policy call is
``torch.func.vmap`` over ``torch.func.functional_call`` of it, so one call
steps all seeds: the act, the values, the cached encoding, and the update
``vmap(grad(loss of one seed))`` with PPO's loss (``ppo.ppo_loss``). On the
card the slot-attention sweep launches once for all seeds under that vmap
(``ops.slot_routing``'s vmap rule: B3 at S*E rows, B4 at S*batch).

Per seed, exactly single-seed PPO: its own optimizer state in
``StackedOptaxChain`` (optax's chain with the global-norm clip taken per
seed: norms over every axis but the seed axis), its own minibatch
permutations (JAX's numpy rule: per epoch, per seed, ``permutation(n)``
from ``default_rng(seeds[0] ^ 0x5EED)``), its env group (envs
``[i*E, (i+1)*E)`` of the vec env) and its own random numbers: the slot
noise and the categorical sample's Gumbels of every call are drawn outside
the vmapped function from S generators seeded ``seeds[i]`` and
passed in, [S, ...]. A frozen OCR is left out of the optimizer and runs
without autograd. With ``target_kl``, a seed whose minibatch exceeds 1.5 x
target_kl applies neither that update nor any later one of the iteration
(per-seed masking, JAX's ``epochs_update``), and its metrics stay those of
that minibatch.

``cache_frozen_reps`` (a frozen OCR, the rollout's size a multiple of the
minibatch and of 8): the rollout is encoded once, in chunks of
``encode_chunk(n)`` observations per seed, and every minibatch runs only the
heads on the cached representation (``ActorCriticPolicy.heads_from_rep``).
The rollouts: ``collect_rollout`` (one vmapped policy call a vector step),
``collect_rollout_deep`` (``pipeline``: envs in up to 8 buckets per seed,
each bucket's call dispatched to the card while other buckets' envs step)
and ``collect_rollout_pipelined`` (two halves). On the card a dispatched
call returns at once; its packed (action, log-probability, value) comes to
the host through pinned memory behind a CUDA event that the host waits on
only when it needs the result.

An OCR whose forward takes gradients of its own (IODINE: ``vmappable =
False`` on its module) does not run under ``torch.func``; with it every
"vmapped" function runs one call a seed on that seed's parameters and the
gradients come from autograd seed by seed: the same functions, stacked.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from ..config import PPOConfig
from ..device import resolve_device
from .ppo import action_stats, ppo_loss

METRICS = ("policy_loss", "value_loss", "entropy", "approx_kl", "loss")
DEEP_BUCKETS = 8        # collect_rollout_deep's buckets a seed, as JAX's


def encode_chunk(n: int, target: int = 128) -> int:
    """Largest power-of-two chunk <= target dividing n (0 = no fit)."""
    c = target
    while c >= 8:
        if n % c == 0:
            return c
        c //= 2
    return 0


def bucket_envs(num_envs: int, buckets: int = DEEP_BUCKETS) -> int:
    """Envs of a seed in each of ``collect_rollout_deep``'s buckets:
    ``buckets`` halved until it divides ``num_envs``."""
    while buckets > 1 and num_envs % buckets:
        buckets //= 2
    return num_envs // buckets


def _per_seed(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[S] -> [S, 1, ...] to broadcast over ``like`` [S, ...]."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


class StackedOptaxChain:
    """``ppo.OptaxChain`` over parameters stacked on a leading seed axis:
    each seed's own global norm, clip, Adam moments and count. ``step``
    takes an optional [S] mask of the seeds whose update applies."""

    def __init__(self, params: list[torch.Tensor], learning_rate: float, max_norm: float,
                 eps: float = 1e-5, b1: float = 0.9, b2: float = 0.999):
        self.kind = "adam"
        self.params = list(params)
        self.lr, self.max_norm, self.eps, self.b1, self.b2 = \
            learning_rate, max_norm, eps, b1, b2
        S = self.params[0].shape[0]
        self.count = torch.zeros(S, dtype=torch.int64, device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads, apply: torch.Tensor | None = None) -> torch.Tensor:
        """One update of every seed (of those ``apply`` holds); returns each
        seed's global norm before the clip, [S]."""
        S = self.count.shape[0]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.reshape(S, -1), dim=1) for g in grads]), dim=0)
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        grads = [g * _per_seed(scale, g) for g in grads]
        count = self.count + 1
        mu = torch._foreach_add(torch._foreach_mul(self.mu, self.b1), grads,
                                alpha=1 - self.b1)
        nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        c = count.double()
        bc1, bc2 = (1 - self.b1 ** c).float(), (1 - self.b2 ** c).float()
        params = []
        for p, m, v in zip(self.params, mu, nu):
            update = (m / _per_seed(bc1, m)) / (torch.sqrt(v / _per_seed(bc2, v)) + self.eps)
            params.append(p + update * -self.lr)
        if apply is None:
            self.count = count
            keep = [(self.params, params), (self.mu, mu), (self.nu, nu)]
            for own, new in keep:
                for t, n in zip(own, new):
                    t.copy_(n)
        else:
            self.count = torch.where(apply, count, self.count)
            for own, new in ((self.params, params), (self.mu, mu), (self.nu, nu)):
                for t, n in zip(own, new):
                    t.copy_(torch.where(_per_seed(apply, t), n, t))
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count.clone(), "mu": [t.clone() for t in self.mu],
                "nu": [t.clone() for t in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        self.count = torch.as_tensor(state["count"]).to(self.count.device, torch.int64).clone()
        for own, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for t, s in zip(own, saved, strict=True):
                t.copy_(s)


class _ToHost:
    """A device tensor on its way to the host: on the card, copied into
    pinned memory behind a CUDA event (``get`` waits on the event alone);
    on the CPU, the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _Buffers:
    """One rollout of n_steps vector steps in the per-seed layout
    [n_steps, S, E]."""

    def __init__(self, n_steps: int, S: int, E: int, obs_shape, obs_dtype):
        self.obs = np.empty((n_steps, S, E) + tuple(obs_shape), obs_dtype)
        self.actions = np.empty((n_steps, S, E), np.int32)
        self.logprobs = np.empty((n_steps, S, E), np.float32)
        self.values = np.empty((n_steps, S, E), np.float32)
        self.rewards = np.empty((n_steps, S, E), np.float32)
        self.dones = np.empty((n_steps, S, E), np.float32)
        self.ep_infos: list[list] = [[] for _ in range(S)]

    def record_act(self, t: int, sl, obs, packed: np.ndarray) -> np.ndarray:
        """The observations and the packed [S, 3, e] (action, log-probability,
        value) of the envs ``sl`` at step t; returns the actions [S, e]."""
        action = packed[:, 0].astype(np.int32)
        self.obs[t][:, sl] = obs
        self.actions[t][:, sl] = action
        self.logprobs[t][:, sl] = packed[:, 1]
        self.values[t][:, sl] = packed[:, 2]
        return action

    def record_step(self, t: int, sl, rewards, dones, infos, env_index, E: int) -> None:
        shape = self.rewards[t][:, sl].shape
        self.rewards[t][:, sl] = rewards.reshape(shape)
        self.dones[t][:, sl] = dones.reshape(shape)
        for j, info in enumerate(infos):
            if "is_success" in info and "terminal_observation" in info:
                self.ep_infos[int(env_index[j]) // E].append(info)

    def batch(self, last_values: np.ndarray, gamma: float, gae_lambda: float) -> dict:
        """GAE on the host (SB3's semantics, no timeout bootstrapping); every
        array [S, n_steps * E, ...]."""
        n_steps = self.rewards.shape[0]
        advantages = np.zeros_like(self.rewards)
        gae = np.zeros(self.rewards.shape[1:], np.float32)
        for t in reversed(range(n_steps)):
            next_v = last_values if t == n_steps - 1 else self.values[t + 1]
            nonterminal = 1.0 - self.dones[t]
            delta = self.rewards[t] + gamma * next_v * nonterminal - self.values[t]
            gae = delta + gamma * gae_lambda * nonterminal * gae
            advantages[t] = gae
        returns = advantages + self.values

        def per_seed(a):  # (n_steps, S, E, ...) -> (S, n_steps*E, ...)
            return np.ascontiguousarray(a.swapaxes(0, 1)).reshape(
                (a.shape[1], n_steps * a.shape[2]) + a.shape[3:])

        return {"obs": per_seed(self.obs), "actions": per_seed(self.actions),
                "logprobs": per_seed(self.logprobs), "values": per_seed(self.values),
                "advantages": per_seed(advantages), "returns": per_seed(returns)}


class MultiSeedPPO:
    """PPO of S seeds as one vmapped computation; see the module docstring.
    ``policies``: one policy per seed, built alike (``build_policy(config,
    seed=s)``); ``num_envs`` envs per seed."""

    def __init__(self, policies: list[nn.Module], obs_shape, is_image_obs: bool,
                 num_envs: int, config: PPOConfig, seeds, freeze_ocr: bool | None = None,
                 pipeline: bool = False, cache_frozen_reps: bool = False,
                 device: str | torch.device | None = None):
        self.seeds = [int(s) for s in seeds]
        self.S = len(self.seeds)
        if len(policies) != self.S:
            raise ValueError(f"{len(policies)} policies for {self.S} seeds")
        self.device = resolve_device(device)
        self.policy = policies[0].to(self.device).eval()
        self.vmappable = getattr(self.policy.ocr_module, "vmappable", True)
        if freeze_ocr is not None:
            self.policy.freeze_ocr = bool(freeze_ocr)
        self.cfg = config
        self.obs_shape = tuple(obs_shape)
        self.is_image_obs = is_image_obs
        self.num_envs = num_envs
        self.pipeline = bool(pipeline) and num_envs % 2 == 0
        self.cache_reps = bool(cache_frozen_reps) and self.policy.freeze_ocr
        self._np_rng = np.random.default_rng(self.seeds[0] ^ 0x5EED)
        self.generators = [torch.Generator(device=self.device).manual_seed(s)
                           for s in self.seeds]
        self.num_actions = self.policy.action_net.out_features
        self.params = {name: torch.stack([dict(p.named_parameters())[name].detach()
                                          for p in policies]).to(self.device).contiguous()
                       for name, _ in self.policy.named_parameters()}
        self.num_timesteps = 0              # over all seeds
        self.last_iteration: dict = {}
        self._new_optimizer()

    def _new_optimizer(self) -> None:
        frozen = self.policy.freeze_ocr
        self.param_names = [n for n in self.params
                            if not (frozen and n.startswith("ocr_module."))]
        self.optimizer = StackedOptaxChain([self.params[n] for n in self.param_names],
                                           self.cfg.learning_rate, self.cfg.max_grad_norm)

    # -- the functions of one seed, vmapped ------------------------------------

    def _prep(self, obs) -> torch.Tensor:
        obs = torch.as_tensor(obs).to(self.device, non_blocking=True).to(torch.float32)
        return obs / 255.0 if self.is_image_obs else obs

    def _noise(self, B: int, generators=None) -> torch.Tensor | None:
        """[S, ...] slot noise for B observations a seed, each seed's from
        its own generator; None for an OCR that draws nothing."""
        shape_fn = getattr(self.policy.ocr_module, "noise_shape", None)
        shape = shape_fn(B) if shape_fn is not None else None
        if shape is None:
            return None
        return torch.stack([torch.randn(shape, generator=g, device=self.device)
                            for g in generators or self.generators])

    def _gumbels(self, B: int, generators=None) -> torch.Tensor:
        """[S, B, A] Gumbel(0, 1) draws for the categorical samples."""
        return torch.stack([-torch.log(torch.empty((B, self.num_actions), device=self.device)
                                       .exponential_(generator=g))
                            for g in generators or self.generators])

    def _outputs(self, params, obs, noise):
        return functional_call(self.policy, params, (obs,), {"noise": noise})

    def _act_one(self, params, obs, noise, gumbel):
        logits, value = self._outputs(params, obs, noise)
        action = torch.argmax(logits + gumbel, dim=-1)
        logprob = torch.log_softmax(logits, dim=-1).gather(1, action[:, None])[:, 0]
        return torch.stack([action.to(torch.float32), logprob, value])

    def _det_one(self, params, obs, noise):
        return torch.argmax(self._outputs(params, obs, noise)[0], dim=-1)

    def _values_one(self, params, obs, noise):
        return self._outputs(params, obs, noise)[1]

    def _vmapped(self, fn, params, *args):
        """``fn`` of one seed over every seed: one vmapped call, or one call
        a seed, stacked, for an OCR that is not ``vmappable``."""
        if self.vmappable:
            dims = (0,) + tuple(None if a is None else 0 for a in args)
            return vmap(fn, in_dims=dims)(params, *args)
        return torch.stack([fn({k: v[i] for k, v in params.items()},
                               *(None if a is None else a[i] for a in args))
                            for i in range(self.S)])

    def _grads(self, train: dict, rest: dict, minibatch: dict, noise):
        """(each seed's gradients of its loss, stacked; its metrics, [S])."""
        if self.vmappable:
            return vmap(grad(self._loss_one, has_aux=True),
                        in_dims=(0, 0, 0, None if noise is None else 0))(
                            train, rest, minibatch, noise)
        grads, metrics = [], []
        for i in range(self.S):
            leaves = {k: v[i].detach().requires_grad_() for k, v in train.items()}
            with torch.enable_grad():
                loss, m = self._loss_one(leaves, {k: v[i] for k, v in rest.items()},
                                         {k: v[i] for k, v in minibatch.items()},
                                         None if noise is None else noise[i])
                g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads.append([torch.zeros_like(x) if d is None else d
                          for x, d in zip(leaves.values(), g)])
            metrics.append(m)
        return ({k: torch.stack([g[j] for g in grads]) for j, k in enumerate(train)},
                {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]})

    @torch.inference_mode()
    def act_device(self, obs) -> torch.Tensor:
        """obs [S, e, ...] -> packed [S, 3, e] (sampled action, its
        log-probability, value) on the device, not waited for."""
        e = obs.shape[1]
        return self._vmapped(self._act_one, self.params, self._prep(obs), self._noise(e),
                             self._gumbels(e))

    @torch.inference_mode()
    def act_deterministic_device(self, obs) -> torch.Tensor:
        """obs [S, e, ...] -> argmax actions [S, e] on the device."""
        return self._vmapped(self._det_one, self.params, self._prep(obs),
                             self._noise(obs.shape[1]))

    @torch.inference_mode()
    def values_host(self, obs) -> np.ndarray:
        """obs [S, E, ...] -> values [S, E] on the host."""
        return self._vmapped(self._values_one, self.params, self._prep(obs),
                             self._noise(obs.shape[1])).cpu().numpy()

    # -- rollouts --------------------------------------------------------------

    def _obs_dtype(self):
        return np.uint8 if self.is_image_obs else np.float32

    def collect_rollout(self, vec_env, obs, n_steps: int,
                        step_callback: Optional[Callable] = None):
        """``n_steps`` vector steps, one vmapped policy call each; the vec
        env has S * E envs, envs [i*E, (i+1)*E) seed i's. -> (last obs, the
        rollout [S, n_steps*E, ...], the finished episodes' infos per seed)."""
        S, E = self.S, self.num_envs
        if vec_env.num_envs != S * E:
            raise ValueError(f"the vec env has {vec_env.num_envs} envs, not {S} x {E}")
        buf = _Buffers(n_steps, S, E, obs.shape[1:], self._obs_dtype())
        every = np.arange(S * E)
        for t in range(n_steps):
            grouped = obs.reshape((S, E) + obs.shape[1:])
            packed = _ToHost(self.act_device(grouped)).get()
            action = buf.record_act(t, slice(None), grouped, packed)
            obs, rewards, dones, infos = vec_env.step(action.reshape(-1))
            buf.record_step(t, slice(None), rewards, dones, infos, every, E)
            self.num_timesteps += S * E
            if step_callback is not None:
                step_callback(self)
        last_values = self.values_host(obs.reshape((S, E) + obs.shape[1:]))
        return obs, buf.batch(last_values, self.cfg.gamma, self.cfg.gae_lambda), buf.ep_infos

    def _collect_buckets(self, vec_env, obs, n_steps: int, buckets: int,
                         step_callback: Optional[Callable], halves: bool):
        S, E = self.S, self.num_envs
        if vec_env.num_envs != S * E:
            raise ValueError(f"the vec env has {vec_env.num_envs} envs, not {S} x {E}")
        EB = bucket_envs(E, buckets)
        B = E // EB
        buf = _Buffers(n_steps, S, E, obs.shape[1:], self._obs_dtype())
        slices = [slice(i * EB, (i + 1) * EB) for i in range(B)]
        idx = [np.array([s * E + e for s in range(S) for e in range(sl.start, sl.stop)])
               for sl in slices]
        grouped = obs.reshape((S, E) + obs.shape[1:])
        cur = [np.ascontiguousarray(grouped[:, sl]) for sl in slices]
        inflight: list = [None] * B

        def dispatch(b):
            inflight[b] = _ToHost(self.act_device(cur[b]))

        def step_bucket(b, t, action):
            o, rewards, dones, infos = vec_env.step_indices(idx[b], action.reshape(-1))
            cur[b] = o.reshape((S, EB) + o.shape[1:])
            buf.record_step(t, slices[b], rewards, dones, infos, idx[b], E)

        if halves:      # JAX's collect_rollout_pipelined: one call in flight
            dispatch(0)
            for t in range(n_steps):
                act_a = buf.record_act(t, slices[0], cur[0], inflight[0].get())
                dispatch(1)
                step_bucket(0, t, act_a)
                act_b = buf.record_act(t, slices[1], cur[1], inflight[1].get())
                if t + 1 < n_steps:
                    dispatch(0)
                step_bucket(1, t, act_b)
                self.num_timesteps += S * E
                if step_callback is not None:
                    step_callback(self)
        else:           # JAX's collect_rollout_deep: up to B calls in flight
            for b in range(B):
                dispatch(b)
            for t in range(n_steps):
                for b in range(B):
                    action = buf.record_act(t, slices[b], cur[b], inflight[b].get())
                    step_bucket(b, t, action)
                    if t + 1 < n_steps:
                        dispatch(b)
                self.num_timesteps += S * E
                if step_callback is not None:
                    step_callback(self)
        full = np.concatenate(cur, axis=1)                 # (S, E, ...)
        last_values = self.values_host(full)
        obs = full.reshape((S * E,) + full.shape[2:])
        return obs, buf.batch(last_values, self.cfg.gamma, self.cfg.gae_lambda), buf.ep_infos

    def collect_rollout_deep(self, vec_env, obs, n_steps: int,
                             step_callback: Optional[Callable] = None,
                             buckets: int = DEEP_BUCKETS):
        """``collect_rollout`` with each seed's envs in ``buckets`` buckets
        (halved until it divides E): every bucket's policy call is dispatched
        as soon as its envs have stepped, and the host waits on the oldest
        only when it needs its actions (ocrl_tpu/rl/multi_seed.py:371-463)."""
        return self._collect_buckets(vec_env, obs, n_steps, buckets, step_callback, False)

    def collect_rollout_pipelined(self, vec_env, obs, n_steps: int,
                                  step_callback: Optional[Callable] = None):
        """``collect_rollout`` with each seed's envs in two halves: one
        half's envs step while the other half's call is in flight
        (ocrl_tpu/rl/multi_seed.py:464-555). E must be even."""
        if self.num_envs % 2:
            raise ValueError("the pipelined rollout needs an even number of envs a seed")
        return self._collect_buckets(vec_env, obs, n_steps, 2, step_callback, True)

    # -- updates ---------------------------------------------------------------

    def upload(self, batch: dict) -> dict:
        """The rollout [S, n, ...] on the device, once."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def _loss_one(self, train, rest, minibatch, noise):
        params = {**train, **rest}
        if "rep" in minibatch:
            logits, values = functional_call(self.policy, params, (minibatch["rep"],),
                                             {"from_rep": True})
        else:
            logits, values = self._outputs(params, self._prep(minibatch["obs"]), noise)
        loss, metrics = ppo_loss(self.cfg, *action_stats(logits, minibatch["actions"]),
                                 values, minibatch)
        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _update(self, data: dict, idx: torch.Tensor, noise, apply_from=None) -> dict:
        """Gradients of every seed's loss on its rows ``idx`` [S, B] of
        ``data``, then one optimizer step; returns the metrics [S] on the
        device. ``apply_from`` (stopped [S]) masks the step by target_kl."""
        rows = torch.arange(self.S, device=self.device)[:, None]
        minibatch = {k: v[rows, idx] for k, v in data.items()}
        train = {n: self.params[n] for n in self.param_names}
        rest = {n: p for n, p in self.params.items() if n not in train}
        if noise is None and "rep" not in minibatch:
            noise = self._noise(idx.shape[1])
        elif noise is not None:    # its first rows (IODINE's batch is its axis 1)
            axis = getattr(self.policy.ocr_module, "noise_batch_axis", 0)
            noise = noise.narrow(1 + axis, 0, idx.shape[1])
        grads, metrics = self._grads(train, rest, minibatch, noise)
        apply = None
        if apply_from is not None:
            ok = metrics["approx_kl"] <= 1.5 * self.cfg.target_kl
            apply = ~apply_from & ok
            metrics["stopped"] = apply_from | ~ok
        self.optimizer.step([grads[n] for n in self.param_names], apply)
        return metrics

    def update_minibatch(self, data: dict, idx, noise: torch.Tensor | None = None) -> dict:
        """One vmapped update of every seed on its rows ``idx`` [S, B] of the
        uploaded rollout ``data``; ``noise`` [S, ...] the OCR's noise for
        those rows (``noise_shape``). Returns the metrics, [S] device
        tensors."""
        return self._update(data, torch.as_tensor(idx, device=self.device), noise)

    def _encode(self, obs: torch.Tensor, chunk: int) -> torch.Tensor:
        """Every seed's rollout [S, n, ...] through its frozen OCR, ``chunk``
        observations a seed at a time, vmapped over the seeds."""
        ocr = {n[len("ocr_module."):]: p for n, p in self.params.items()
               if n.startswith("ocr_module.")}

        def one(params, obs, noise):
            return functional_call(self.policy.ocr_module, params, (obs,), {"noise": noise})

        with torch.no_grad():
            reps = [self._vmapped(one, ocr, self._prep(obs[:, i:i + chunk]),
                                  self._noise(chunk))
                    for i in range(0, obs.shape[1], chunk)]
        return torch.cat(reps, dim=1)

    def train_on_rollout(self, batch: dict, noise: torch.Tensor | None = None) -> dict:
        """``n_epochs`` over each seed's rollout [S, n, ...] in minibatches
        of ``batch_size``, the permutations by JAX's rule; ``noise`` [S,
        batch_size, ...], when given, is every minibatch's slot noise.
        Returns the metrics, numpy [S] each."""
        cfg, S = self.cfg, self.S
        n = batch["obs"].shape[1]
        data = self.upload(batch)
        divisible = n % cfg.batch_size == 0
        perms = np.stack([np.stack([self._np_rng.permutation(n) for _ in range(S)])
                          for _ in range(cfg.n_epochs)])            # (epochs, S, n)
        chunk = encode_chunk(n) if self.cache_reps and divisible else 0
        if chunk:
            data["rep"] = self._encode(data.pop("obs"), chunk)
        use_kl = cfg.target_kl is not None
        stopped = torch.zeros(S, dtype=torch.bool, device=self.device)
        last, updates = None, 0
        for epoch in range(cfg.n_epochs):
            order = torch.from_numpy(perms[epoch]).to(self.device)
            for start in range(0, n, cfg.batch_size):
                metrics = self._update(data, order[:, start:start + cfg.batch_size], noise,
                                       stopped if use_kl else None)
                updates += 1
                if use_kl:
                    # metrics freeze at the seed's stopping minibatch
                    last = metrics if last is None else {
                        k: torch.where(stopped, last[k], metrics[k]) for k in METRICS}
                    stopped = metrics.pop("stopped")
                    if not divisible and bool(stopped.all()):
                        break
                else:
                    last = metrics
            if use_kl and not divisible and bool(stopped.all()):
                break
        self.last_iteration["updates"] = updates
        return {k: last[k].cpu().numpy() for k in METRICS}

    def learn(self, vec_env, total_timesteps: int,
              iteration_callback: Optional[Callable] = None,
              step_callback: Optional[Callable] = None):
        """Rollouts and updates until ``total_timesteps`` env steps a seed
        (``num_timesteps`` counts all seeds')."""
        obs = vec_env.reset()
        n_steps = max(self.cfg.n_steps // self.num_envs, 1)
        collect = self.collect_rollout_deep if self.pipeline else self.collect_rollout
        while self.num_timesteps < total_timesteps * self.S:
            t0 = time.perf_counter()
            obs, batch, ep_infos = collect(vec_env, obs, n_steps, step_callback)
            t1 = time.perf_counter()
            metrics = self.train_on_rollout(batch)
            t2 = time.perf_counter()
            self.last_iteration.update(rollout_s=t1 - t0, update_s=t2 - t1,
                                       env_steps=n_steps * vec_env.num_envs)
            if iteration_callback is not None:
                iteration_callback(self, metrics, ep_infos)
        return self

    # -- persistence -----------------------------------------------------------

    def save(self) -> dict:
        """The state in memory: stacked parameters, optimizer state,
        timesteps, seeds."""
        return {"policy_params": {k: v.clone() for k, v in self.params.items()},
                "opt_state": self.optimizer.state_dict(),
                "num_timesteps": self.num_timesteps, "seeds": list(self.seeds)}

    def load(self, ckpt: dict) -> None:
        saved = [int(s) for s in ckpt.get("seeds", self.seeds)]
        if saved != self.seeds:
            raise ValueError(
                f"checkpoint was trained with seeds={saved} but this run has "
                f"seeds={self.seeds}: per-seed params would be misattributed")
        for k, v in ckpt["policy_params"].items():
            self.params[k].copy_(v)
        if "opt_state" in ckpt:
            self.optimizer.load_state_dict(ckpt["opt_state"])
        self.num_timesteps = int(ckpt.get("num_timesteps", 0))

    # -- batched cross-seed evaluation -----------------------------------------

    def evaluate_all(self, env, n_episodes: int = 100, deterministic: bool = False) -> list:
        """Every seed at once on a multi-seed vec env (envs [i*E, (i+1)*E)
        seed i's), one vmapped policy call a vector step, SB3's per-env
        episode targets (ocrl_tpu/rl/multi_seed.py:641-684). -> one dict of
        success_rate, mean_reward, mean_ep_length a seed."""
        S = self.S
        if env.num_envs % S:
            raise ValueError(f"{env.num_envs} envs do not split into {S} seeds")
        E = env.num_envs // S
        targets = np.array([n_episodes // E + (1 if i < n_episodes % E else 0)
                            for i in range(E)])
        counts = np.zeros((S, E), np.int64)
        ep_return = np.zeros((S, E), np.float64)
        ep_len = np.zeros((S, E), np.int64)
        per_seed = [{"successes": [], "returns": [], "lengths": []} for _ in range(S)]
        obs = env.reset()
        while (counts < targets[None, :]).any():
            grouped = obs.reshape((S, E) + obs.shape[1:])
            if deterministic:
                actions = self.act_deterministic_device(grouped).cpu().numpy()
            else:
                actions = _ToHost(self.act_device(grouped)).get()[:, 0].astype(np.int64)
            obs, rewards, dones, infos = env.step(actions.reshape(-1))
            ep_return += rewards.reshape(S, E)
            ep_len += 1
            for flat in np.nonzero(dones)[0]:
                s, i = divmod(int(flat), E)
                if counts[s, i] < targets[i]:
                    counts[s, i] += 1
                    acc = per_seed[s]
                    acc["returns"].append(ep_return[s, i])
                    acc["lengths"].append(ep_len[s, i])
                    acc["successes"].append(float(infos[flat].get("is_success", False)))
                ep_return[s, i] = 0.0
                ep_len[s, i] = 0
        return [{"success_rate": float(np.mean(a["successes"])),
                 "mean_reward": float(np.mean(a["returns"])),
                 "mean_ep_length": float(np.mean(a["lengths"]))} for a in per_seed]

    def seed_view(self, i: int) -> "_SeedView":
        return _SeedView(self, i)


class _SeedView:
    """``predict`` of one seed of a MultiSeedPPO (ocrl_tpu/rl/multi_seed.py:686-706)."""

    def __init__(self, algo: MultiSeedPPO, i: int):
        self._algo, self._i = algo, i
        self.obs_shape = algo.obs_shape

    @torch.inference_mode()
    def predict(self, obs, deterministic: bool = True):
        algo, i = self._algo, self._i
        obs = np.asarray(obs)
        squeeze = obs.ndim == len(algo.obs_shape)
        if squeeze:
            obs = obs[None]
        gens = [algo.generators[i]]
        noise = algo._noise(obs.shape[0], gens)
        params = {k: v[i] for k, v in algo.params.items()}
        logits, _ = algo._outputs(params, algo._prep(obs), None if noise is None else noise[0])
        if not deterministic:
            logits = logits + algo._gumbels(obs.shape[0], gens)[0]
        action = torch.argmax(logits, dim=-1).cpu().numpy()
        return action[0] if squeeze else action
