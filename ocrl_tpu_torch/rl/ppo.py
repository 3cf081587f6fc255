"""PPO and A2C (counterpart of ocrl_tpu/rl/ppo.py): the act surface
(``prep``, ``act``, ``act_deterministic``, ``values``, ``predict``), rollouts
with GAE on the host, and the updates.

SB3 1.5 semantics, as the JAX package keeps them: rollouts of
``n_steps // num_envs`` steps per env, GAE(lambda) without timeout
bootstrapping; PPO takes ``n_epochs`` of shuffled minibatches, the final
partial one included, each with its advantages normalised (by the
population std; not for a minibatch of one), the clipped ratio, the value
loss and the entropy bonus; A2C takes one step on the whole rollout.

The optimizers are optax's, written out (``OptaxChain``):
``clip_by_global_norm(max_grad_norm)`` (g * max_norm / norm once the norm
reaches max_norm), then ``adam(lr, eps=1e-5)`` for PPO or
``rmsprop(lr, decay=0.99, eps)`` with eps inside the square root and the
accumulator starting at 0 for A2C. With a frozen OCR, its parameters are
left out: no update, no optimizer state, no share of the norm, and its
forward runs without autograd (``ActorCriticPolicy.ocr_rep``). With
``target_kl`` set, a minibatch whose approx_kl exceeds 1.5 x target_kl is
not applied and ends the epochs.

Random numbers (the slot initialisation, the categorical sample, the seed
of the minibatch permutations) come from the algorithm's own
``torch.Generator``, made from ``seed`` on the policy's device; ``noise=``
gives the slot initialisation explicitly instead. ``save`` / ``load`` keep
the state in memory; ``utils.checkpoint.save_algo`` / ``load_algo`` write
and read it as JAX's agent file (``{"policy_params", "opt_state",
"num_timesteps"}``), which JAX's ``test_sb3`` and ``+resume=`` read. Several
seeds trained as one vmapped computation are ``rl.multi_seed.MultiSeedPPO``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..config import A2CConfig, PPOConfig
from ..device import resolve_device


def action_stats(logits: torch.Tensor, actions: torch.Tensor):
    """(log-probabilities of ``actions`` [B], the mean entropy) of the
    categorical of ``logits`` [B, A]."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logprob = logp_all.gather(1, actions.long()[:, None])[:, 0]
    entropy = -(logp_all.exp() * logp_all).sum(-1).mean()
    return logprob, entropy


def ppo_loss(cfg: PPOConfig, logprob: torch.Tensor, entropy: torch.Tensor,
             values: torch.Tensor, minibatch: dict):
    """PPO's loss and its metrics on one minibatch (ocrl_tpu/rl/ppo.py and
    ocrl_tpu/rl/multi_seed.py:141-166): the advantages normalised by the
    population std (not for a minibatch of one, as SB3), the clipped ratio,
    the value loss and the entropy bonus; approx_kl as SB3 computes it."""
    adv = minibatch["advantages"]
    if cfg.normalize_advantage and adv.shape[0] > 1:   # SB3: not for size 1
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logprob - minibatch["logprobs"])
    clipped = adv * torch.clamp(ratio, 1 - cfg.clip_range, 1 + cfg.clip_range)
    policy_loss = -torch.minimum(adv * ratio, clipped).mean()
    value_loss = ((minibatch["returns"] - values) ** 2).mean()
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    approx_kl = ((ratio - 1) - torch.log(ratio)).mean()
    return loss, {"policy_loss": policy_loss, "value_loss": value_loss,
                  "entropy": entropy, "approx_kl": approx_kl}


class OptaxChain:
    """optax.chain(clip_by_global_norm(max_norm), adam | rmsprop) over
    ``params``, or with ``max_norm`` None the optimizer alone (SAC's
    ``optax.adam``): ``step(grads)`` takes one gradient per parameter (None
    counts as zeros, as JAX's gradient of an unused parameter)."""

    def __init__(self, params: list[torch.Tensor], kind: str, learning_rate: float,
                 max_norm: float | None, eps: float, b1: float = 0.9, b2: float = 0.999,
                 decay: float = 0.99):
        if kind not in ("adam", "rmsprop"):
            raise ValueError(f"optimizer must be adam or rmsprop, not '{kind}'")
        self.params = list(params)
        self.kind, self.lr, self.max_norm, self.eps = kind, learning_rate, max_norm, eps
        self.b1, self.b2, self.decay = b1, b2, decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params] if kind == "adam" else []
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor | None:
        """Apply one update; returns the gradients' global norm before the
        clip (None without one)."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = None
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                self.max_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        if self.kind == "adam":
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
            mu_hat = torch._foreach_div(self.mu, 1 - self.b1 ** self.count)
            denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - self.b2 ** self.count))
            torch._foreach_add_(denom, self.eps)
            updates = torch._foreach_div(mu_hat, denom)
        else:
            torch._foreach_mul_(self.nu, self.decay)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.decay)
            updates = torch._foreach_mul(grads, torch._foreach_rsqrt(
                torch._foreach_add(self.nu, self.eps)))
        torch._foreach_add_(self.params, updates, alpha=-self.lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [t.clone() for t in self.mu],
                "nu": [t.clone() for t in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for own, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for t, s in zip(own, saved, strict=True):
                t.copy_(s)


class OnPolicyAlgo:
    """What PPO and A2C share: acting, rollouts, the optimizer over the
    trainable parameters, persistence."""

    def __init__(self, policy: nn.Module, obs_shape, is_image_obs: bool = True,
                 num_envs: int = 1, seed: int = 0, freeze_ocr: bool | None = None,
                 device: str | torch.device | None = None, *, optimizer: str = "adam",
                 learning_rate: float = 3e-4, max_grad_norm: float = 0.5,
                 eps: float = 1e-5):
        self.device = resolve_device(device)
        self.policy = policy.to(self.device).eval()
        if freeze_ocr is not None:
            self.policy.freeze_ocr = bool(freeze_ocr)
        self.obs_shape = tuple(obs_shape)
        self.is_image_obs = is_image_obs
        self.num_envs = num_envs
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.num_timesteps = 0
        self.last_iteration: dict = {}
        self.param_names = [name for name, _ in self.trainable()]
        self.optimizer = OptaxChain([p for _, p in self.trainable()], optimizer,
                                    learning_rate, max_grad_norm, eps)

    def trainable(self) -> list[tuple[str, nn.Parameter]]:
        """(name, parameter) of what the update moves: all but the OCR's
        when it is frozen."""
        frozen = getattr(self.policy, "freeze_ocr", False)
        return [(n, p) for n, p in self.policy.named_parameters()
                if not (frozen and n.startswith("ocr_module."))]

    # -- acting ----------------------------------------------------------------

    def prep(self, obs) -> torch.Tensor:
        """Observations cross to the device raw (uint8 for images: a quarter
        of the bytes) and become float32 there, in [0, 1] for images."""
        obs = torch.as_tensor(obs).to(self.device).to(torch.float32)
        return obs / 255.0 if self.is_image_obs else obs

    @torch.inference_mode()
    def act(self, obs, noise: torch.Tensor | None = None):
        """-> (sampled action [B], its log-probability [B], value [B])."""
        logits, value = self.policy(self.prep(obs), noise=noise,
                                    generator=self.generator)
        logp = torch.log_softmax(logits, dim=-1)
        action = torch.multinomial(logp.exp(), 1, generator=self.generator)
        return action[:, 0], logp.gather(1, action)[:, 0], value

    @torch.inference_mode()
    def act_deterministic(self, obs, noise: torch.Tensor | None = None):
        """-> (argmax action [B], logits [B, A], value [B])."""
        logits, value = self.policy(self.prep(obs), noise=noise,
                                    generator=self.generator)
        return logits.argmax(-1), logits, value

    @torch.inference_mode()
    def values(self, obs, noise: torch.Tensor | None = None) -> torch.Tensor:
        return self.policy(self.prep(obs), noise=noise, generator=self.generator)[1]

    def predict(self, obs, deterministic: bool = False,
                noise: torch.Tensor | None = None) -> np.ndarray:
        """Actions for one observation or a batch, as numpy."""
        obs = np.asarray(obs)
        squeeze = obs.ndim == len(self.obs_shape)
        if squeeze:
            obs = obs[None]
        act = self.act_deterministic if deterministic else self.act
        action = act(obs, noise)[0].cpu().numpy()
        return action[0] if squeeze else action

    # -- rollouts --------------------------------------------------------------

    def collect_rollout(self, vec_env, obs, n_steps: int, gamma: float,
                        gae_lambda: float, step_callback: Optional[Callable] = None):
        """``n_steps`` vector steps from ``obs``: one policy call each (its
        action, log-probability and value cross to the host together), then
        the bootstrap value of the last observation and GAE on the host
        (ocrl_tpu/rl/ppo.py:169-227). -> (last obs, the rollout flattened
        over (step, env), the infos of finished episodes)."""
        E = vec_env.num_envs
        obs_dtype = np.uint8 if self.is_image_obs else np.float32
        buf_obs = np.empty((n_steps, E) + obs.shape[1:], obs_dtype)
        buf_actions = np.empty((n_steps, E), np.int32)
        buf_logprobs = np.empty((n_steps, E), np.float32)
        buf_values = np.empty((n_steps, E), np.float32)
        buf_rewards = np.empty((n_steps, E), np.float32)
        buf_dones = np.empty((n_steps, E), np.float32)
        ep_infos = []
        for t in range(n_steps):
            action, logprob, value = self.act(obs)
            out = torch.stack([action.to(torch.float32), logprob, value]).cpu().numpy()
            buf_obs[t] = obs
            buf_actions[t] = out[0]
            buf_logprobs[t] = out[1]
            buf_values[t] = out[2]
            next_obs, rewards, dones, infos = vec_env.step(buf_actions[t])
            buf_rewards[t] = rewards
            buf_dones[t] = dones
            for info in infos:
                if "is_success" in info and "terminal_observation" in info:
                    ep_infos.append(info)
            self.num_timesteps += E
            obs = next_obs
            if step_callback is not None:
                step_callback(self)

        last_values = self.values(obs).cpu().numpy()

        # GAE (SB3 buffers.py semantics; episodic: no timeout bootstrapping)
        advantages = np.zeros_like(buf_rewards)
        gae = np.zeros(E, np.float32)
        for t in reversed(range(n_steps)):
            next_v = last_values if t == n_steps - 1 else buf_values[t + 1]
            nonterminal = 1.0 - buf_dones[t]
            delta = buf_rewards[t] + gamma * next_v * nonterminal - buf_values[t]
            gae = delta + gamma * gae_lambda * nonterminal * gae
            advantages[t] = gae
        returns = advantages + buf_values

        batch = {
            "obs": buf_obs.reshape((-1,) + buf_obs.shape[2:]),
            "actions": buf_actions.reshape(-1),
            "logprobs": buf_logprobs.reshape(-1),
            "values": buf_values.reshape(-1),
            "advantages": advantages.reshape(-1),
            "returns": returns.reshape(-1),
        }
        return obs, batch, ep_infos

    # -- updates ---------------------------------------------------------------

    def upload(self, batch: dict) -> dict:
        """The rollout on the device, once; minibatches gather from it."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def _forward(self, minibatch: dict, noise: torch.Tensor | None):
        """(log-probabilities of the taken actions, entropy, values)."""
        if noise is not None:      # its first rows (IODINE's batch is its axis 1)
            axis = getattr(self.policy.ocr_module, "noise_batch_axis", 0)
            noise = noise.narrow(axis, 0, minibatch["obs"].shape[0])
        logits, values = self.policy(self.prep(minibatch["obs"]), noise=noise,
                                     generator=self.generator)
        return action_stats(logits, minibatch["actions"]) + (values,)

    def _loss(self, minibatch: dict, noise):
        raise NotImplementedError

    def _update(self, minibatch: dict, noise, target_kl: float | None = None) -> dict:
        """Loss, gradients of the trainable parameters and, unless the
        minibatch is over the KL limit, one optimizer step. Returns the
        metrics as device tensors."""
        with torch.enable_grad():
            loss, metrics = self._loss(minibatch, noise)
            grads = torch.autograd.grad(loss, self.optimizer.params, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        # JAX applies the update where approx_kl <= 1.5 target_kl (so not on NaN)
        if target_kl is None or bool(metrics["approx_kl"] <= 1.5 * target_kl):
            self.optimizer.step(grads)
        return metrics

    def learn(self, vec_env, total_timesteps: int,
              iteration_callback: Optional[Callable] = None,
              step_callback: Optional[Callable] = None):
        """Rollouts and updates until ``total_timesteps`` env steps; each
        iteration's seconds and update count land in ``last_iteration``."""
        obs = vec_env.reset()
        n_steps = max(self.cfg.n_steps // vec_env.num_envs, 1)
        while self.num_timesteps < total_timesteps:
            t0 = time.perf_counter()
            obs, batch, ep_infos = self.collect_rollout(
                vec_env, obs, n_steps, self.cfg.gamma, self.cfg.gae_lambda,
                step_callback)
            t1 = time.perf_counter()
            metrics = self.train_on_rollout(batch)
            t2 = time.perf_counter()
            self.last_iteration.update(rollout_s=t1 - t0, update_s=t2 - t1,
                                       env_steps=n_steps * vec_env.num_envs,
                                       policy_calls=n_steps + 1)
            if iteration_callback is not None:
                iteration_callback(self, metrics, ep_infos)
        return self

    # -- persistence -----------------------------------------------------------

    def save(self) -> dict:
        """The state in memory: parameters, optimizer state, timesteps."""
        return {"policy_params": {k: v.clone() for k, v in self.policy.state_dict().items()},
                "opt_state": self.optimizer.state_dict(),
                "num_timesteps": self.num_timesteps}

    def load(self, ckpt: dict) -> None:
        self.policy.load_state_dict(ckpt["policy_params"])
        if "opt_state" in ckpt:
            self.optimizer.load_state_dict(ckpt["opt_state"])
        self.num_timesteps = int(ckpt.get("num_timesteps", 0))


class PPO(OnPolicyAlgo):
    def __init__(self, policy: nn.Module, obs_shape, is_image_obs: bool = True,
                 num_envs: int = 1, config: PPOConfig | None = None, seed: int = 0,
                 freeze_ocr: bool | None = None,
                 device: str | torch.device | None = None):
        self.cfg = config = config or PPOConfig()
        super().__init__(policy, obs_shape, is_image_obs, num_envs, seed, freeze_ocr,
                         device, optimizer="adam", learning_rate=config.learning_rate,
                         max_grad_norm=config.max_grad_norm, eps=1e-5)

    def _loss(self, minibatch: dict, noise):
        return ppo_loss(self.cfg, *self._forward(minibatch, noise), minibatch)

    def update_minibatch(self, data: dict, idx: torch.Tensor,
                         noise: torch.Tensor | None = None) -> dict:
        """One minibatch update on the rows ``idx`` of the uploaded rollout
        ``data`` (gathered on the device). Returns the metrics (device
        tensors), those of a minibatch over the KL limit too."""
        minibatch = {k: v.index_select(0, idx) for k, v in data.items()}
        return self._update(minibatch, noise, self.cfg.target_kl)

    def train_on_rollout(self, batch: dict, noise: torch.Tensor | None = None) -> dict:
        """``n_epochs`` over the rollout in minibatches of ``batch_size``,
        each epoch in the order of a permutation from a numpy generator seeded
        from the algorithm's. ``noise`` [batch_size, S, D], when given, is
        every minibatch's slot noise (its first rows for a shorter one).
        Returns the last minibatch's metrics as floats."""
        cfg = self.cfg
        n = batch["obs"].shape[0]
        data = self.upload(batch)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator,
                                 device=self.device).item())
        rng_np = np.random.default_rng(seed)
        metrics, updates = {}, 0
        for _ in range(cfg.n_epochs):
            perm = torch.from_numpy(rng_np.permutation(n)).to(self.device)
            stop = False
            for start in range(0, n, cfg.batch_size):
                metrics = self.update_minibatch(data, perm[start:start + cfg.batch_size],
                                                noise)
                updates += 1
                if cfg.target_kl is not None and \
                        float(metrics["approx_kl"]) > 1.5 * cfg.target_kl:
                    stop = True
                    break
            if stop:
                break
        self.last_iteration["updates"] = updates
        return {k: float(v) for k, v in metrics.items()}


class A2C(OnPolicyAlgo):
    def __init__(self, policy: nn.Module, obs_shape, is_image_obs: bool = True,
                 num_envs: int = 1, config: A2CConfig | None = None, seed: int = 0,
                 freeze_ocr: bool | None = None,
                 device: str | torch.device | None = None):
        self.cfg = config = config or A2CConfig()
        super().__init__(policy, obs_shape, is_image_obs, num_envs, seed, freeze_ocr,
                         device, optimizer="rmsprop", learning_rate=config.learning_rate,
                         max_grad_norm=config.max_grad_norm, eps=config.rms_eps)

    def _loss(self, minibatch: dict, noise):
        cfg = self.cfg
        logprob, entropy, values = self._forward(minibatch, noise)
        policy_loss = -(minibatch["advantages"] * logprob).mean()
        value_loss = ((minibatch["returns"] - values) ** 2).mean()
        loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
        return loss, {"policy_loss": policy_loss, "value_loss": value_loss,
                      "entropy": entropy}

    def train_on_rollout(self, batch: dict, noise: torch.Tensor | None = None) -> dict:
        """One step on the whole rollout; the metrics as floats."""
        metrics = self._update(self.upload(batch), noise)
        self.last_iteration["updates"] = 1
        return {k: float(v) for k, v in metrics.items()}
