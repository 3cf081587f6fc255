"""The port's SAC against the JAX package's (the reference, in the same
process; nothing of ocrl_tpu changes for it):

- ``SACConfig`` and the ``sb3=sac`` group against ``compose``;
- ``sample_squashed`` and a policy call (``predict``, stochastic and
  deterministic) on given normals, and the replay buffer (ring wrap,
  uint8 storage, ``sample``'s indices from one ``default_rng``) bitwise;
- two updates on the same converted parameters, batches and noise (JAX's
  ``jax.random.normal`` replaced by the test's arrays while it traces;
  slot noise and Gaussians by their rank), with a small SLATE (one slot
  iteration) on ``cw-target`` images end to end (ent_coef 1e-3) and frozen
  (``auto_0.1``), and with GT on the states (``auto_0.1``, and 1e-3): each
  entry of each loss, parameter, target parameter, Adam moment and
  ``log_alpha`` within TOL x scale of JAX's, plus JAX's own distance there
  from JAX's float64 run (x64) of the same updates; the scale is
  max(|value|, 1) for losses and max(|leaf|, 1e-2) for the rest. The
  float64 run is made only where TOL alone is not met. That happens where
  fp32 is ill-conditioned: the entropy sums log(1 - a^2 + 1e-6) with
  a = tanh(u), and where |a| nears 1 an ulp of tanh moves that term by
  1e-7 / (1 - a^2); with ``auto_0.1`` (alpha 0.1) the actor's gradient
  carries that error to entries below Adam's eps (1e-5), where Adam's step
  is linear in them;
- the reference's quirks, kept: the pooling frozen with the OCR, and the
  target's OCR left at its random init by ``inject_pretrained_ocr``;
- a short ``learn`` on the CW states against JAX's: ``num_timesteps``, the
  buffer (its random phase bitwise) and the parameters and ``log_alpha``
  after 5 updates within TOL x scale;
- agent files both ways (JAX's strict ``load_checkpoint`` reads the port's,
  the port reads JAX's), and ``train_sb3.main`` with ``sb3=sac`` on the CPU
  at small widths: its files, JAX reading them, ``resume=`` bitwise;
- ``test_sb3`` scores PPO and A2C agents only, as JAX's.
"""

import dataclasses
import functools
import json
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import ocrl_tpu.envs as jenvs
from ocrl_tpu.config import compose
from ocrl_tpu.rl import SAC as JSAC
from ocrl_tpu.rl import SACConfig as JSACConfig
from ocrl_tpu.models import build_spec
from ocrl_tpu.poolings import create_pooling_module as jcreate_pooling_module
from ocrl_tpu.rl import SACPolicy as JSACPolicy
from ocrl_tpu.rl import inject_pretrained_ocr as jinject
from ocrl_tpu.rl import sac as jsac
from ocrl_tpu.rl.vec_env import VecEnv as JVecEnv
from ocrl_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from ocrl_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import test_sb3, train_sb3
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.envs.spaces import Box
from ocrl_tpu_torch.rl import SAC, ReplayBuffer, VecEnv, build_sac_policy, inject_pretrained_ocr
from ocrl_tpu_torch.rl.sac import sample_squashed
from ocrl_tpu_torch.utils.checkpoint import agent_tree, load_algo, load_checkpoint, save_algo
from ocrl_tpu_torch.utils.convert import from_flax, sac_optax_moments

TOL = 1e-5
METRIC_FLOOR, LEAF_FLOOR = 1.0, 1e-2
SMALL_SLATE = ["ocr=slate", "pooling=transformer", "ocr.cnn.hidden_size=16",
               "ocr.slotattr.num_slots=3", "ocr.slotattr.slot_size=32",
               "ocr.slotattr.mlp_hidden_size=32", "ocr.slotattr.num_iterations=1",
               "pooling.d_model=32", "pooling.nhead=4"]
CW = ["sb3=sac", "sb3_acnet=mlp", "env=cw-target-N4C4S1S1", "env.use_fake_sim=true"]
SETUPS = {   # name: (overrides, ent_coef, freeze, image observations)
    "slate-e2e": (SMALL_SLATE, 1e-3, False, True),
    "slate-frozen": (SMALL_SLATE, "auto_0.1", True, True),
    "gt-auto": (["ocr=gt", "pooling=mlp", "env.render_mode=state"], "auto_0.1", False, False),
    "gt-fixed": (["ocr=gt", "pooling=mlp", "env.render_mode=state"], 1e-3, False, False),
}
B = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small ops on one thread (tier-1 runs six workers); the
    count is put back after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def argv(overrides: list[str], ent=None) -> list[str]:
    return overrides[:1] + CW + overrides[1:] + (
        [] if ent is None else [f"sb3.algo_kwargs.ent_coef={ent}"])


def obs_shape(image: bool) -> tuple:
    return (64, 64, 3) if image else (5, 40)


@functools.lru_cache(maxsize=None)
def jax_policy(overrides: tuple):
    """JAX's SACPolicy module of ``overrides``, as ``build_sac_policy``
    builds it but from the OCR's spec: the SAC initialises every
    parameter itself, and the whole OCR's own initialisation takes
    seconds."""
    cfg = compose("train_sb3", argv(list(overrides)))
    spec = build_spec(cfg.ocr, cfg.env)
    pooling = jcreate_pooling_module(cfg.pooling.name, spec.rep_dim, spec.num_slots,
                                     cfg.pooling, cfg.env.get("num_stacked_obss", 1))
    return JSACPolicy(ocr_module=spec.module, pooling_module=pooling, action_dim=3,
                      freeze_ocr=False)


class Pair:
    """JAX's SAC and the port's on the same initial weights, and JAX's float64
    run (x64) of the same updates as the reference of their fp32 rounding."""

    def __init__(self, setup: str, freeze: bool | None = None, **sac):
        overrides, ent, frozen, self.image = SETUPS[setup]
        self.freeze = freeze = frozen if freeze is None else freeze
        jpolicy = jax_policy(tuple(overrides))
        if freeze:
            jpolicy = jpolicy.clone(freeze_ocr=True)
        conf = dict(dict(batch_size=B, ent_coef=ent), **sac)     # sac.yaml's lr, 1e-4
        self.j = JSAC(jpolicy, obs_shape(self.image), self.image, 2, JSACConfig(**conf),
                      seed=0, freeze_ocr=freeze)
        self.t = port_sac(setup, freeze, **sac)
        self.t.policy.load_state_dict(from_flax(jax.tree.map(np.asarray, self.j.params)))
        self.t.target.load_state_dict(self.t.policy.state_dict())
        self.start = {k: v.clone() for k, v in self.t.policy.state_dict().items()}
        self.ref_state = jax.tree.map(np.asarray, (self.j.params, self.j.target_params,
                                                   self.j.opt_state, self.j.log_alpha,
                                                   self.j.alpha_opt_state))
        self.steps, self.ref_steps = [], 0

    def batch(self, seed: int) -> dict:
        rng = np.random.default_rng(seed)
        shape = (B,) + obs_shape(self.image)
        obs = [rng.integers(0, 256, shape, dtype=np.uint8) if self.image
               else rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        return {"obs": obs[0], "next_obs": obs[1],
                "actions": rng.uniform(-1, 1, (B, 3)).astype(np.float32),
                "rewards": (rng.random(B) < 0.5).astype(np.float32),
                "dones": (rng.random(B) < 0.3).astype(np.float32)}

    def jax_update(self, batch: dict, noise: dict) -> dict:
        """JAX's update; its inputs and draws are kept for ``reference``."""
        scale = 255.0 if self.image else 1.0
        host = {k: v.astype(np.float32) / scale if k.endswith("obs") else v
                for k, v in batch.items()}
        j = self.j
        self.steps.append((host, noise))
        with patched(noise), jax.default_matmul_precision("highest"):
            (j.params, j.target_params, j.opt_state, j.log_alpha, j.alpha_opt_state,
             metrics) = j._update(j.params, j.target_params, j.opt_state, j.log_alpha,
                                  j.alpha_opt_state, jax.tree.map(jnp.asarray, host),
                                  jax.random.PRNGKey(0))
        return {k: float(v) for k, v in metrics.items()}

    def reference(self) -> tuple:
        """JAX's float64 run (x64) of every update so far, from the initial
        fp32 state cast: its (params, target_params, opt_state, log_alpha)
        and the last update's metrics."""
        with jax.default_matmul_precision("highest"), jax.enable_x64(True):
            for host, noise in self.steps[self.ref_steps:]:
                with patched(noise):
                    *state, metrics = self.j._update(*jax.tree.map(widen, self.ref_state),
                                                     jax.tree.map(widen, host),
                                                     jax.random.PRNGKey(0))
                self.ref_state = jax.tree.map(np.asarray, tuple(state))
                self.ref_metrics = {k: np.asarray(v) for k, v in metrics.items()}
        self.ref_steps = len(self.steps)
        return self.ref_state[:4], self.ref_metrics

    def port_update(self, batch: dict, noise: dict) -> dict:
        n = {k: torch.from_numpy(v[:B]) for k, v in noise.items()}
        out = self.t.update(self.t.upload(batch), {"slots": n.get(3), "slots_next": n.get(3),
                                                   "eps_next": n[2], "eps_pi": n[2]})
        return {k: float(v) for k, v in out.items()}

    def check(self, got: dict, want: dict) -> None:
        """The rule of the module docstring. It adds JAX's distance from its
        float64 run to TOL, so that run is made only where TOL alone is not
        met."""
        try:
            self.hold(got, want, None)
        except AssertionError:
            self.hold(got, want, self.reference())

    def hold(self, got: dict, want: dict, ref: tuple | None) -> None:
        (params64, target64, opt64, log_alpha64), metrics64 = ref or ((None,) * 4, None)
        assert set(got) == set(want)
        for k, w in want.items():
            agree(got[k], w, None if ref is None else metrics64[k],
                  max(abs(w), METRIC_FLOOR), k)
        for what, mine, theirs, ref64 in (
                ("parameter", self.t.policy, self.j.params, params64),
                ("target", self.t.target, self.j.target_params, target64)):
            close(mine.state_dict(), from_flax(jax.tree.map(np.asarray, theirs)), what,
                  None if ref is None else from_flax(ref64))
        moments = sac_optax_moments(serialization.to_state_dict(
            jax.tree.map(np.asarray, self.j.opt_state)))
        moments64 = moments if ref is None else \
            sac_optax_moments(serialization.to_state_dict(opt64))
        for group, (count, mu, nu) in moments.items():
            opt, names = self.t.optimizers[group], self.t.param_names[group]
            assert opt.count == count == moments64[group][0]
            close(dict(zip(names, opt.mu)), mu, f"{group} mu",
                  None if ref is None else moments64[group][1])
            close(dict(zip(names, opt.nu)), nu, f"{group} nu",
                  None if ref is None else moments64[group][2])
        close({"log_alpha": self.t.log_alpha}, {"log_alpha": np.asarray(self.j.log_alpha)},
              "log_alpha", None if ref is None else {"log_alpha": log_alpha64})


def port_sac(setup: str, freeze: bool, **sac) -> SAC:
    """The port's SAC of ``setup`` from its own seed's weights."""
    overrides, image = SETUPS[setup][0], SETUPS[setup][3]
    tconf = tcfg.compose(tcfg.TrainSB3Config(), argv(overrides))
    policy = build_sac_policy(tconf, Box(-1.0, 1.0, (3,), np.float32), seed=1, device="cpu")[0]
    policy.freeze_ocr = freeze
    return SAC(policy, obs_shape(image), image, 2,
               tcfg.SACConfig(**dict(dict(batch_size=B, ent_coef=SETUPS[setup][1]), **sac)),
               seed=0, device="cpu")


def widen(x):
    """A float leaf as float64 (under x64); integer leaves (step counts) as
    they are."""
    x = np.asarray(x)
    return jnp.asarray(x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x)


def _np(x) -> np.ndarray:
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


def agree(got, want, ref, scale: float, what: str) -> None:
    """``got`` (the port) within TOL x ``scale`` of ``want`` (JAX), entry by
    entry, plus JAX's own distance there from ``ref`` (JAX's float64 run);
    without ``ref``, within TOL x ``scale`` alone."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want)
    theirs = np.zeros_like(err) if ref is None else np.abs(want - _np(ref))
    bad = err > TOL * scale + theirs
    assert not bad.any(), \
        f"{what}: {int(bad.sum())} of {bad.size} entries farther from JAX than {TOL} x " \
        f"{scale:.3e} + JAX's distance from float64; worst {float(err.max()):.3e} " \
        f"(JAX from float64 there {float(theirs.flat[err.argmax()]):.3e})"


def close(got: dict, want: dict, what: str, ref: dict | None = None,
          floor: float = LEAF_FLOOR) -> None:
    """Each leaf by ``agree`` with the scale max(its largest |entry|,
    ``floor``)."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    assert ref is None or set(ref) == set(want), (what, sorted(set(ref) ^ set(want))[:5])
    for k, w in want.items():
        scale = max(float(np.abs(_np(w)).max()), floor)
        agree(got[k], w, None if ref is None else ref[k], scale, f"{what} {k}")


@contextmanager
def patched(noise: dict):
    """JAX's normal draws replaced by the test's arrays, by rank: [B, S, D]
    slot noise, [B, A] Gaussians (their leading block of the drawn shape)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(
                       noise[len(shape)][tuple(slice(0, n) for n in shape)], dtype))
        yield


def draws(seed: int, rows: int = B) -> dict:
    rng = np.random.default_rng(seed)
    return {3: rng.standard_normal((rows, 3, 32)).astype(np.float32),
            2: rng.standard_normal((rows, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def slate_e2e():
    return Pair("slate-e2e")


def test_sac_config_matches_jax():
    cfg = compose("train_sb3", ["ocr=gt", "pooling=mlp"] + CW)
    want = JSACConfig.from_algo_kwargs(cfg.sb3.algo_kwargs.to_dict())
    port = tcfg.compose(tcfg.TrainSB3Config(), ["ocr=gt", "pooling=mlp"] + CW)
    assert port.sb3.name == cfg.sb3.name == "SAC"
    assert dataclasses.asdict(port.sb3.algo_kwargs) == dataclasses.asdict(want)
    assert isinstance(port.env, tcfg.CwEnvConfig) and port.env.use_fake_sim
    auto = tcfg.compose(tcfg.TrainSB3Config(), CW + ["sb3.algo_kwargs.ent_coef=auto_0.1"])
    assert auto.sb3.algo_kwargs.ent_coef == "auto_0.1"
    assert tcfg.compose(tcfg.TrainSB3Config(), CW + ["sb3.algo_kwargs.ent_coef=1"]) \
        .sb3.algo_kwargs.ent_coef == 1.0


def test_sample_squashed_matches_jax():
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((6, 3)).astype(np.float32)
    log_std = rng.uniform(-3, 1, (6, 3)).astype(np.float32)
    eps = rng.standard_normal((6, 3)).astype(np.float32)
    with patched({2: eps}):
        want_a, want_logp = jsac.sample_squashed(jnp.asarray(mu), jnp.asarray(log_std),
                                                 jax.random.PRNGKey(0))
    a, logp = sample_squashed(torch.from_numpy(mu), torch.from_numpy(log_std),
                              torch.from_numpy(eps))
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("deterministic", [False, True])
def test_predict_matches_jax(slate_e2e, deterministic):
    """A policy call at E = 2 on the same slot noise and normals, scaled to
    the action space in float32 as JAX's ``_scale_action`` (not the identity
    on [-1, 1]): within TOL of JAX's actions."""
    obs = np.random.default_rng(40).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    noise = draws(41, rows=2)
    with patched(noise), jax.default_matmul_precision("highest"):
        want = slate_e2e.j.predict(obs, deterministic=deterministic)
    got = slate_e2e.t.predict(obs, deterministic, noise={
        "slots": torch.from_numpy(noise[3]), "eps": torch.from_numpy(noise[2])})
    assert got.dtype == want.dtype == np.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    a = np.float32([-1.0, 0.3, 1.0])
    assert slate_e2e.t.scale_action(a).tobytes() == slate_e2e.j._scale_action(a).tobytes()


@pytest.mark.parametrize("image", [True, False])
def test_replay_buffer_matches_jax(image):
    shape = obs_shape(image)
    want, got = (cls(10, shape, 3, image) for cls in (jsac.ReplayBuffer, ReplayBuffer))
    rng = np.random.default_rng(1)
    for n in (4, 4, 3, 4):                          # wraps twice
        obs = [rng.integers(0, 256, (n,) + shape, dtype=np.uint8) if image
               else rng.standard_normal((n,) + shape) for _ in range(2)]
        action = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        reward, done = rng.random(n).astype(np.float32), rng.random(n) < 0.3
        for buf in (want, got):
            buf.add(obs[0], obs[1], action, reward, done)
    assert (len(got), got.pos, got.full) == (len(want), want.pos, want.full) == (10, 5, True)
    assert got.obs.dtype == (np.uint8 if image else np.float32)
    for key in ("obs", "next_obs", "actions", "rewards", "dones"):
        assert getattr(got, key).tobytes() == getattr(want, key).tobytes(), key
    w = want.sample(7, np.random.default_rng(2))
    g = got.sample(7, np.random.default_rng(2))
    scale = 255.0 if image else 1.0
    for key in w:
        host = g[key].astype(np.float32) / scale if key.endswith("obs") else g[key]
        assert host.tobytes() == w[key].tobytes(), key
    data = SAC.upload(type("A", (), {"device": torch.device("cpu"), "is_image_obs": image})(),
                      g)
    assert data["obs"].numpy().tobytes() == w["obs"].tobytes()


@pytest.mark.parametrize("setup", SETUPS)
def test_updates_match_jax(setup, request):
    pair = request.getfixturevalue("slate_e2e") if setup == "slate-e2e" else Pair(setup)
    noise = draws(20)              # JAX's traced update keeps the draws it was traced with
    for step in range(2):
        batch = pair.batch(10 + step)
        want = pair.jax_update(batch, noise)
        got = pair.port_update(batch, noise)
        pair.check(got, want)
    assert ("alpha_loss" in got) == (SETUPS[setup][1] == "auto_0.1")
    if pair.freeze:       # JAX freezes the pooling with the OCR: both stay bitwise
        after = pair.t.policy.state_dict()
        kept = [k for k in after if k.startswith(("ocr_module.", "pooling_module."))]
        assert kept and all(torch.equal(after[k], pair.start[k]) for k in kept)
        assert set(pair.t.group_names()["frozen"]) == \
            {k for k, _ in pair.t.policy.named_parameters()
             if k.startswith(("ocr_module.", "pooling_module."))}


def test_inject_leaves_the_target_ocr_as_it_is(slate_e2e):
    """JAX's inject_pretrained_ocr replaces the online OCR and the optimizer
    state and leaves target_params as they are (ocrl_tpu/rl/extractor.py:75-77),
    so a fresh run's target OCR keeps its random init; the port does the same."""
    j, t = slate_e2e.j, slate_e2e.t
    target_before = from_flax({"ocr_module": jax.tree.map(np.asarray,
                                                          j.target_params["ocr_module"])})
    port_before = {k: v.clone() for k, v in t.target.state_dict().items()}
    pretrained = jax.tree.map(lambda x: np.asarray(x) + 0.5, j.params["ocr_module"])
    jinject(j, type("OCR", (), {"params": pretrained})())
    state = {k[len("ocr_module."):]: v for k, v in from_flax({"ocr_module": pretrained}).items()}
    module = type("M", (), {"state_dict": lambda self: state})()
    inject_pretrained_ocr(t, type("OCR", (), {"module": module})())
    assert same_leaves(from_flax({"ocr_module": jax.tree.map(
        np.asarray, j.target_params["ocr_module"])}), target_before)
    assert same_leaves(t.target.state_dict(), port_before)
    online = {k: v for k, v in t.policy.state_dict().items() if k.startswith("ocr_module.")}
    assert same_leaves(online, from_flax({"ocr_module": pretrained}))
    assert all(opt.count == 0 for opt in t.optimizers.values())
    assert int(serialization.to_state_dict(j.opt_state)["inner_states"]["critic"]
               ["inner_state"]["0"]["count"]) == 0


def same_leaves(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in want)


def test_learn_matches_jax(monkeypatch):
    """GT on the CW states, 2 envs: 4 random vector steps, the first update
    after the last of them, then 4 policy steps, each followed by an update;
    the buffer of 10 wraps (its rows 6-7 still hold the random phase)."""
    pair = Pair("gt-auto", learning_starts=8, buffer_size=10)
    made = []

    class Recorded(jsac.ReplayBuffer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jsac, "ReplayBuffer", Recorded)
    noise = draws(30, rows=B)
    jcfg = compose("train_sb3", argv(SETUPS["gt-auto"][0])).env
    tcfg_ = tcfg.replace(tcfg.compose(tcfg.TrainSB3Config(), argv(SETUPS["gt-auto"][0])).env,
                         "use_fake_sim", True)
    with patched(noise), jax.default_matmul_precision("highest"):
        pair.j.learn(JVecEnv([lambda s=s: jenvs.CwTargetEnv(jcfg, s) for s in (3, 4)]), 16)
    monkeypatch.setattr(SAC, "_normal", lambda self, rows: torch.from_numpy(noise[2][:rows]))
    pair.t.learn(VecEnv([lambda s=s: make_env(tcfg_, s) for s in (3, 4)]), 16)
    assert pair.t.num_timesteps == pair.j.num_timesteps == 16
    assert pair.t.totals["updates"] == 5 and pair.t.totals["policy_steps"] == 4
    got, want = pair.t.buffer, made[0]
    assert (got.pos, got.full) == (want.pos, want.full) == (6, True)
    assert got.actions[6:8].tobytes() == want.actions[6:8].tobytes()
    for key in ("rewards", "dones"):
        assert getattr(got, key).tobytes() == getattr(want, key).tobytes(), key
    for key in ("obs", "next_obs", "actions"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=1e-5)
    close(pair.t.policy.state_dict(), from_flax(jax.tree.map(np.asarray, pair.j.params)),
          "parameter")
    close({"log_alpha": pair.t.log_alpha}, {"log_alpha": np.asarray(pair.j.log_alpha)},
          "log_alpha")


@pytest.mark.parametrize("freeze", [False, True])
def test_agent_files_both_ways(freeze, tmp_path):
    """GT on the states; frozen, the pooling is SAC's frozen group."""
    pair = Pair("gt-auto", freeze=freeze)
    batch = pair.batch(5)
    pair.port_update(batch, draws(6))
    pair.t.num_timesteps = 1234
    save_algo(tmp_path / "port.ckpt", pair.t, {"num_timesteps": 1234})
    tree, meta = jload_checkpoint(tmp_path / "port.ckpt", pair.j.save())
    assert meta == {"num_timesteps": 1234} and tree["num_timesteps"] == 1234
    want = load_checkpoint(tmp_path / "port.ckpt")[0]
    assert same_tree(serialization.to_state_dict(jax.tree.map(np.asarray, tree)), want)
    pair.j.load(tree)

    pair.jax_update(pair.batch(7), draws(6))
    jsave_checkpoint(tmp_path / "jax.ckpt", pair.j.save(), {"num_timesteps": 99})
    fresh = port_sac("gt-auto", freeze)
    assert bool(fresh.group_names()["frozen"]) == freeze
    assert load_algo(tmp_path / "jax.ckpt", fresh) == {"num_timesteps": 99}
    assert fresh.num_timesteps == 1234 and fresh.optimizers["critic"].count == 2
    assert same_tree(agent_tree(fresh), load_checkpoint(tmp_path / "jax.ckpt")[0])


def same_tree(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys() and \
            all(same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_train_sb3_sac_writes_jax_files_and_resumes(slate_e2e, tmp_path):
    run = tmp_path / "run"
    base = argv(SMALL_SLATE) + [
        "num_envs=2", "vec_env=dummy", "sb3.algo_kwargs.learning_starts=8",
        "sb3.algo_kwargs.batch_size=4", "sb3.algo_kwargs.buffer_size=50", "eval.freq=5",
        "eval.n_episodes=2", "eval.num_envs=2", "video.length=3", f"run_dir={run}"]
    first = train_sb3.main(base + ["max_steps=14"], device="cpu")
    algo = first["algo"]
    assert algo.num_timesteps == 14 and algo.totals["updates"] == 4
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    train = [r for r in records if "train/critic_loss" in r]
    assert [r["_step"] for r in train] == [8, 10, 12, 14]
    assert all(np.isfinite(v) for r in train for k, v in r.items() if k.startswith("train/"))
    assert any("eval/success_rate" in r for r in records)
    assert sorted(p.name for p in (run / "models").iterdir()) == ["best_model.ckpt",
                                                                  "latest_model.ckpt"]
    gif = (run / "videos" / "rollout_step2.gif").read_bytes()
    assert gif[:6] == b"GIF89a" and int.from_bytes(gif[6:8], "little") == 256
    tree, meta = jload_checkpoint(run / "models" / "latest_model.ckpt", slate_e2e.j.save())
    assert meta["num_timesteps"] == 14 and tree["num_timesteps"] == 14

    saved = load_checkpoint(run / "models" / "latest_model.ckpt")[0]
    resumed = train_sb3.main(base + ["max_steps=14", f"run_dir={tmp_path / 'again'}",
                                     f"resume={run / 'models' / 'latest_model.ckpt'}"],
                             device="cpu")
    assert same_tree(agent_tree(resumed["algo"]), saved)
    longer = train_sb3.main(base + ["max_steps=16", f"run_dir={tmp_path / 'longer'}",
                                    f"resume={run / 'models' / 'latest_model.ckpt'}"],
                            device="cpu")
    assert longer["algo"].num_timesteps == 16 and longer["algo"].totals["updates"] == 1
    assert longer["algo"].totals["policy_steps"] == 1


def test_test_sb3_scores_ppo_and_a2c_only(tmp_path):
    with pytest.raises(ValueError, match="PPO and A2C"):
        test_sb3.main(["ocr=gt", "pooling=mlp"] + CW + ["env.render_mode=state",
                                                         "n_eval_episodes=1"], device="cpu")
    with pytest.raises(ValueError, match="Box"):
        train_sb3.main(["ocr=gt", "sb3=sac", "env=target-N4C4S3S1", "max_steps=1",
                        "num_envs=1", "vec_env=dummy", f"run_dir={tmp_path}"],
                       device="cpu")
