"""The port's RL slice against the JAX package (the reference, in the same
process; nothing of ocrl_tpu changes for it):

- GAE and the rollout buffers of ``collect_rollout`` on a scripted env and a
  scripted policy, bitwise;
- PPO minibatch updates, one and three, at small SLATE widths (obs 16, as
  the other parity tests) end to end and with the OCR frozen, and at GT's
  full width; the clip above and below the global norm, an over-KL abort, a
  final partial minibatch and one of size 1; one A2C update. Both sides get
  the same minibatches and the same slot noise (JAX's normal draw replaced
  by the test's array), and the same permutations. Loss metrics,
  parameters and the optimizer's moments are held to 1e-5 relative, each
  to its scale (``Pair.check``; fp32 sums in other orders through the
  whole policy and its gradient);
- ``evaluate_policy`` with a scripted deterministic policy, batched and
  serial, exactly.

The committed agents are held in test_torch_sb3.py.
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ocrl_tpu.envs as jenvs
from ocrl_tpu.config import compose
from ocrl_tpu.rl import A2C as JA2C
from ocrl_tpu.rl import PPO as JPPO
from ocrl_tpu.rl import A2CConfig as JA2CConfig
from ocrl_tpu.rl import PPOConfig as JPPOConfig
from ocrl_tpu.rl import build_policy as jbuild_policy
from ocrl_tpu.rl import evaluate_policy as jevaluate_policy
from ocrl_tpu.rl.vec_env import VecEnv as JVecEnv

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.rl import A2C, PPO, VecEnv, build_policy, evaluate_policy
from ocrl_tpu_torch.utils.convert import from_flax

from test_torch_models import SMALL_JAX, small_port_config

TOL = 1e-5
# Scales below which TOL applies as to the floor: a loss metric is a mean of
# O(1) terms (normalised advantages times ratios near 1) that cancel, so its
# scale is 1; a parameter leaf's own scale is at least 1e-2 (zero-initialised biases and
# the CLS token hold only their Adam steps of about lr = 3e-4, and Adam turns
# float noise of a gradient entry near its eps 1e-5 into a few 1e-5 of a
# step); a moment leaf is compared to the model's largest entry of that
# moment (leaves whose gradient is zero by symmetry, such as the attention
# key bias and slot attention's norm_slots bias, hold float noise only).
METRIC_FLOOR, PARAM_FLOOR = 1.0, 1e-2
GT_JAX = ["ocr=gt", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp", "env=push-N3C4S1S1"]
METRICS = ("policy_loss", "value_loss", "entropy", "approx_kl", "loss")


def gt_port_config(env="push-N3C4S1S1", **pooling):
    cfg = tcfg.PolicyConfig(ocr=tcfg.GTConfig(), env=tcfg.read_env_config(env))
    for key, value in pooling.items():
        cfg = tcfg.replace(cfg, f"pooling.{key}", value)
    return cfg


SETUPS = {   # (JAX overrides, port config, obs shape, image observations)
    "slate": (SMALL_JAX, small_port_config, (16, 16, 3), True),
    "gt": (GT_JAX, gt_port_config, (5, 5), False),
}


def _arrays(tree):
    """A parameter-shaped tree without optax's masked (frozen) leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _arrays(v)
            if sub:
                out[k] = sub
        elif hasattr(v, "shape"):
            out[k] = np.asarray(v)
    return out


def _moments(state):
    """(mu or None, nu) of the Adam or RMSprop state inside an optax state."""
    if hasattr(state, "nu"):
        return getattr(state, "mu", None), state.nu
    if isinstance(state, dict):
        children = state.values()
    elif hasattr(state, "inner_states"):
        children = state.inner_states.values()
    elif hasattr(state, "inner_state"):
        children = [state.inner_state]
    elif isinstance(state, tuple):
        children = state
    else:
        return None
    for child in children:
        found = _moments(child)
        if found is not None:
            return found
    return None


def close(got: dict, want: dict, what: str, floor: float) -> None:
    """Each leaf within TOL of max(its largest entry, ``floor``)."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(g - w).max())
        assert err <= TOL * scale, f"{what} {k}: {err:.3e} > {TOL} x {scale:.3e}"


class Pair:
    """The JAX algorithm and the port's on the same initial weights."""

    def __init__(self, setup, algo: str = "ppo", freeze: bool = False,
                 noise: np.ndarray | None = None, **kwargs):
        jax_args, port_cfg, self.obs_shape, self.is_image = (
            SETUPS[setup] if isinstance(setup, str) else setup)
        self.noise = noise
        cfg = compose("train_sb3", jax_args)
        jpolicy, _, _, _ = jbuild_policy(cfg, seed=0)
        if freeze:
            jpolicy = jpolicy.clone(freeze_ocr=True)
        jcls, jconf, cls, conf = (JPPO, JPPOConfig, PPO, tcfg.PPOConfig) if algo == "ppo" \
            else (JA2C, JA2CConfig, A2C, tcfg.A2CConfig)
        with self.patched():
            self.j = jcls(jpolicy, self.obs_shape, self.is_image, 2, jconf(**kwargs),
                          seed=0, freeze_ocr=freeze)
        policy = build_policy(port_cfg(), seed=1, device="cpu")
        policy.load_state_dict(from_flax(jax.tree.map(np.asarray, self.j.params)))
        self.t = cls(policy, self.obs_shape, self.is_image, 2, conf(**kwargs),
                     freeze_ocr=freeze, device="cpu")
        self.start = {k: v.clone() for k, v in policy.state_dict().items()}
        self.t_noise = None if noise is None else torch.from_numpy(noise)

    @contextmanager
    def patched(self):
        """JAX's slot-noise draw replaced by the test's array (its leading
        block of the drawn shape, so its first rows for a batch of fewer),
        baked in when JAX traces."""
        with pytest.MonkeyPatch.context() as mp:
            if self.noise is not None:
                noise = self.noise
                mp.setattr(jax.random, "normal",
                           lambda key, shape, dtype=jnp.float32: jnp.asarray(
                               noise[tuple(slice(0, n) for n in shape)]))
            yield

    def jax_update(self, data: dict, idx) -> dict:
        with self.patched(), jax.default_matmul_precision("highest"):
            self.j.params, self.j.opt_state, metrics = self.j._update(
                self.j.params, self.j.opt_state, {k: jnp.asarray(v) for k, v in data.items()},
                jnp.asarray(idx), jax.random.PRNGKey(0))
        return {k: float(v) for k, v in metrics.items()}

    def port_update(self, data: dict, idx) -> dict:
        metrics = self.t.update_minibatch(self.t.upload(data), torch.as_tensor(idx),
                                          self.t_noise)
        return {k: float(v) for k, v in metrics.items()}

    def check(self, got_metrics: dict, want_metrics: dict,
              param_floor: float = PARAM_FLOOR) -> None:
        """The rule of the module docstring: metrics within TOL of
        max(|value|, METRIC_FLOOR); parameters within TOL of max(the leaf's
        largest entry, PARAM_FLOOR); each optimizer moment within TOL of the
        largest entry of that moment over the whole model."""
        assert set(got_metrics) == set(want_metrics)
        for k, w in want_metrics.items():
            assert abs(got_metrics[k] - w) <= TOL * max(abs(w), METRIC_FLOOR), \
                (k, got_metrics[k], w)
        close(self.t.policy.state_dict(), from_flax(jax.tree.map(np.asarray, self.j.params)),
              "parameter", param_floor)
        want_mu, want_nu = _moments(self.j.opt_state)
        names = self.t.param_names
        for got, want, what in ((self.t.optimizer.mu, want_mu, "mu"),
                                (self.t.optimizer.nu, want_nu, "nu")):
            if want is None:
                assert got == []
                continue
            want = from_flax(_arrays(want))
            top = max(float(v.abs().max()) for v in want.values())
            close(dict(zip(names, got)), want, what, top)


def rollout(n: int, obs_shape, is_image: bool, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    obs = (rng.integers(0, 256, (n,) + obs_shape, dtype=np.uint8) if is_image
           else rng.random((n,) + obs_shape).astype(np.float32))
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return {"obs": obs, "actions": rng.integers(0, 4, n).astype(np.int32),
            "logprobs": f32(np.log(0.25) + 0.3 * rng.standard_normal(n)),
            "values": f32(rng.standard_normal(n)),
            "advantages": f32(rng.standard_normal(n)),
            "returns": f32(rng.standard_normal(n))}


def slate_noise(n: int, seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 3, 32)).astype(np.float32)


@pytest.mark.parametrize("setup,freeze", [("slate", False), ("slate", True), ("gt", False)])
def test_ppo_minibatch_updates_match_jax(setup, freeze):
    """One update, then two more, on minibatches of 4 out of 12."""
    noise = slate_noise(4) if setup == "slate" else None
    pair = Pair(setup, freeze=freeze, noise=noise, batch_size=4)
    data = rollout(12, pair.obs_shape, pair.is_image, seed=1)
    idx = np.random.default_rng(2).permutation(12).reshape(3, 4)
    pair.check(pair.port_update(data, idx[0]), pair.jax_update(data, idx[0]))
    for i in (1, 2):
        got, want = pair.port_update(data, idx[i]), pair.jax_update(data, idx[i])
    pair.check(got, want)
    after = pair.t.policy.state_dict()
    moved = {k for k in after if not torch.equal(after[k], pair.start[k])}
    ocr = {k for k in after if k.startswith("ocr_module.")}
    if freeze:
        assert not moved & ocr and moved      # the OCR bitwise unchanged
        assert not any(n.startswith("ocr_module.") for n in pair.t.param_names)
    elif setup == "slate":
        assert ocr - {"ocr_module.bos"} <= moved   # every used OCR parameter moved


@pytest.mark.parametrize("max_grad_norm", [1e-3, 1e3], ids=["above", "below"])
def test_clip_by_global_norm_matches_jax(max_grad_norm):
    pair = Pair("gt", max_grad_norm=max_grad_norm)
    data = rollout(8, pair.obs_shape, pair.is_image, seed=3)
    for idx in np.random.default_rng(4).permutation(8).reshape(2, 4):
        got, want = pair.port_update(data, idx), pair.jax_update(data, idx)
    pair.check(got, want)
    grads = torch.autograd.grad(
        pair.t._loss(pair.t.upload(data), None)[0], pair.t.optimizer.params,
        allow_unused=True)
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads if g is not None]))
    assert (norm > max_grad_norm) == (max_grad_norm < 1)


def _train_on_rollout(pair: Pair, batch: dict, monkeypatch):
    """Both sides' train_on_rollout with the same permutations: numpy's
    generator seeded 123 whatever seed each side draws."""
    make = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: make(123))
    with pair.patched(), jax.default_matmul_precision("highest"):
        want = pair.j.train_on_rollout(batch)
    got = pair.t.train_on_rollout(batch, pair.t_noise)
    monkeypatch.undo()
    return got, want


def test_partial_and_size_one_minibatches_match_jax(monkeypatch):
    """7 samples in minibatches of 3: 3, 3, 1 an epoch, two epochs; the last
    one of size 1 (no advantage normalisation)."""
    pair = Pair("gt", batch_size=3, n_epochs=2)
    got, want = _train_on_rollout(pair, rollout(7, (5, 5), False, seed=5), monkeypatch)
    assert pair.t.last_iteration["updates"] == 6
    pair.check(got, want)


def test_over_kl_minibatch_is_not_applied_and_stops(monkeypatch):
    """The rollout's log-probabilities are the policy's own: the first
    minibatch (approx_kl about 0) is applied, the second (after it) is over
    1.5 x target_kl, is not applied and ends the epochs."""
    pair = Pair("gt", batch_size=4, target_kl=1e-9)
    batch = rollout(12, (5, 5), False, seed=6)
    logits, _ = pair.j.policy.apply({"params": pair.j.params}, jnp.asarray(batch["obs"]))
    batch["logprobs"] = np.asarray(jax.nn.log_softmax(logits))[
        np.arange(12), batch["actions"]].astype(np.float32)
    start = from_flax(jax.tree.map(np.asarray, pair.j.params))
    got, want = _train_on_rollout(pair, batch, monkeypatch)
    assert pair.t.last_iteration["updates"] == 2
    assert want["approx_kl"] > 1.5e-9 and got["approx_kl"] > 1.5e-9
    pair.check(got, want)
    assert pair.t.optimizer.count == 1
    moved = [k for k, v in pair.t.policy.state_dict().items() if not torch.equal(v, start[k])]
    assert moved


@pytest.mark.parametrize("setup", ["gt", "slate"])
def test_a2c_update_matches_jax(setup):
    noise = slate_noise(10) if setup == "slate" else None
    pair = Pair(setup, algo="a2c", noise=noise)
    batch = rollout(10, pair.obs_shape, pair.is_image, seed=7)
    with pair.patched(), jax.default_matmul_precision("highest"):
        want = pair.j.train_on_rollout(batch)
    got = pair.t.train_on_rollout(batch, pair.t_noise)
    pair.check(got, want)


class ScriptedEnv:
    """A vec env of 3 whose observations, rewards and dones come from a
    numpy generator (dones about one step in five)."""

    num_envs = 3

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def reset(self):
        return self.rng.random((3, 5, 5)).astype(np.float32)

    def step(self, actions):
        assert actions.shape == (3,)
        dones = self.rng.random(3) < 0.2
        infos = [{"is_success": bool(self.rng.random() < 0.5),
                  "terminal_observation": np.zeros((5, 5))} if d else {} for d in dones]
        return (self.rng.random((3, 5, 5)).astype(np.float32),
                self.rng.standard_normal(3).astype(np.float32), dones, infos)


def test_rollout_and_gae_match_jax():
    T = 17
    rng = np.random.default_rng(8)
    actions = rng.integers(0, 4, (T, 3))
    logprobs = rng.standard_normal((T, 3)).astype(np.float32)
    values = rng.standard_normal((T + 1, 3)).astype(np.float32)
    calls, jax_calls = iter(range(T)), iter(range(T))

    class JaxScripted(JPPO):
        def __init__(self):
            self.is_image_obs, self.num_timesteps, self.params = False, 0, None
            self._rng = jax.random.PRNGKey(0)
            self._values = lambda params, obs, key: jnp.asarray(values[T])

        def _act(self, params, obs, key):
            i = next(jax_calls)
            return jnp.asarray(actions[i]), jnp.asarray(logprobs[i]), jnp.asarray(values[i])

    class PortScripted(PPO):
        def __init__(self):
            self.is_image_obs, self.num_timesteps = False, 0

        def act(self, obs, noise=None):
            i = next(calls)
            return (torch.from_numpy(actions[i]), torch.from_numpy(logprobs[i]),
                    torch.from_numpy(values[i]))

        def values(self, obs, noise=None):
            return torch.from_numpy(values[T])

    jenv, tenv = ScriptedEnv(9), ScriptedEnv(9)
    want = JaxScripted().collect_rollout(jenv, jenv.reset(), T, 0.99, 0.95)
    got = PortScripted().collect_rollout(tenv, tenv.reset(), T, 0.99, 0.95)
    np.testing.assert_array_equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for key in want[1]:
        np.testing.assert_array_equal(got[1][key], want[1][key], err_msg=key)
        assert got[1][key].dtype == want[1][key].dtype
    assert [i["is_success"] for i in got[2]] == [i["is_success"] for i in want[2]]
    assert len(got[2]) > 0


class ScriptedAlgo:
    """predict: an action that is a fixed function of the observation."""

    obs_shape = (5, 5)

    def predict(self, obs, deterministic=False):
        obs = np.asarray(obs)
        flat = obs.reshape(-1, 25) if obs.ndim == 3 else obs.reshape(1, 25)
        action = (np.floor(flat.sum(1) * 1000).astype(np.int64) + 1) % 4
        return action if obs.ndim == 3 else action[0]


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "serial"])
def test_evaluate_policy_matches_jax(batched):
    cfg = tcfg.replace(tcfg.read_env_config("target-N4C4S3S1"), "render_mode", "state")
    jcfg = compose("train_sb3", GT_JAX[:-1] + ["env=target-N4C4S3S1",
                                               "env.render_mode=state"]).env
    if batched:
        jenv = JVecEnv([lambda s=s: jenvs.TargetEnv(jcfg, s) for s in range(4)])
        tenv = VecEnv([lambda s=s: make_env(cfg, s) for s in range(4)])
    else:
        jenv, tenv = jenvs.TargetEnv(jcfg, 3), make_env(cfg, 3)
    want = jevaluate_policy(ScriptedAlgo(), jenv, n_episodes=10, deterministic=True)
    got = evaluate_policy(ScriptedAlgo(), tenv, n_episodes=10, deterministic=True)
    assert got == want
    assert 0 < want["mean_ep_length"] <= 100


def test_save_and_load_restore_the_state():
    """save() holds parameters, optimizer state and timesteps in memory;
    load() puts them back after further updates."""
    algo = PPO(build_policy(gt_port_config(), seed=0, device="cpu"), (5, 5), False, 2,
               tcfg.PPOConfig(batch_size=4), device="cpu")
    data = algo.upload(rollout(8, (5, 5), False, seed=9))
    algo.update_minibatch(data, torch.arange(4))
    algo.num_timesteps = 8
    saved = algo.save()
    algo.update_minibatch(data, torch.arange(4, 8))
    algo.num_timesteps = 16
    algo.load(saved)
    assert algo.num_timesteps == 8 and algo.optimizer.count == 1
    for k, v in algo.policy.state_dict().items():
        assert torch.equal(v, saved["policy_params"][k]), k
    for got, want in zip(algo.optimizer.mu + algo.optimizer.nu,
                         saved["opt_state"]["mu"] + saved["opt_state"]["nu"]):
        assert torch.equal(got, want)
