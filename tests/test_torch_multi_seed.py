"""The port's vmapped multi-seed PPO against the JAX package's (the
reference, in the same process; nothing of ocrl_tpu changes for it):

- one vmapped update, then two more, at small SLATE widths (end to end with
  2 seeds, frozen with 3) and GT at full width (3 seeds, and two identical
  seeds, whose slots must stay bitwise equal): each seed's metrics,
  parameters and Adam moments within 1e-5 relative to their scales
  (``test_torch_rl.Pair.check``'s floors; for SLATE end to end after the
  third update, see below ``METRICS``). JAX's normal draw is replaced
  by the test's slot noise, the same for every seed (JAX's vmapped draw
  cannot take one array a seed), and the port gets that noise for each;
- the vmapped update against S single-seed port PPOs on the same
  minibatches and per-seed noise (another noise each seed), the same rule;
- per-seed target_kl masking against JAX's, the minibatch schedule from
  both sides' numpy generator seeded alike (tests/test_rl.py:398);
- cached frozen representations against recomputing them, for a
  deterministic frozen encoder (the VAE's posterior mean);
- the serial, deep (bucketed) and pipelined rollouts with GAE in the
  per-seed layout, on scripted envs with a scripted policy, bitwise;
- ``evaluate_all`` with a scripted deterministic policy, exactly; then
  test_sb3 seeds= with argmax actions on the committed stacked GT agents
  against JAX's ``evaluate_all`` on the same file and env seeds, exactly
  (no argmax near-tie turned an action on these files and seeds);
- ``route_sweep`` under ``torch.func.vmap``, ``grad`` and ``vmap(grad)`` on
  the CPU against the unbatched calls, and the vmap rule of its Functions
  (with the launches replaced by plain versions that refuse wrapped
  tensors): one launch for all seeds at S * B rows.
"""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import jax
import jax.numpy as jnp

import ocrl_tpu.envs as jenvs
from ocrl_tpu.config import compose as jcompose
from ocrl_tpu.rl import PPOConfig as JPPOConfig
from ocrl_tpu.rl import build_policy as jbuild_policy
from ocrl_tpu.rl.multi_seed import MultiSeedPPO as JMultiSeedPPO
from ocrl_tpu.rl.vec_env import make_multi_seed_vec_env as jmake_multi_seed_vec_env
from ocrl_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import test_sb3
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.ops import slot_routing as tsr
from ocrl_tpu_torch.rl import PPO, MultiSeedPPO, build_policy, make_multi_seed_vec_env
from ocrl_tpu_torch.utils.checkpoint import load_agent_tree
from ocrl_tpu_torch.utils.convert import from_flax_stacked

from test_torch_models import SMALL_JAX, small_port_config
from test_torch_rl import (GT_JAX, METRIC_FLOOR, PARAM_FLOOR, TOL, close, gt_port_config,
                           rollout, slate_noise)
from test_torch_rl_ocrs import setup_tuple
from test_torch_run_files import _find, state_dict

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("policy_loss", "value_loss", "entropy", "approx_kl", "loss")
# End to end at small SLATE widths, Adam's second step on seed 2's CNN
# turns gradient entries below its eps (1e-5), which the two frameworks sum
# in other orders, into parameter differences of up to 8.3 x TOL of the
# floor (enc.blocks.0.conv.bias), and the third update's gradients follow
# them (mu 1.5 x TOL of its largest entry). A single-seed PPO on the same
# parameters and minibatches lies exactly as far from JAX's single-seed PPO:
# it is the data's conditioning, not the vmap. That case holds everything
# after the first update; after the other two, the metrics, and each
# parameter within TOL of its floor plus lr x the Adam step gaps that the
# two sides' moments explain, summed over the updates (``adam_step_gap``);
# its state after several updates is held to S single-seed port PPOs below.


def adam_step_gap(mu1, nu1, mu2, nu2, count: int, b1: float, b2: float, eps: float):
    """|u1 - u2| elementwise for Adam's direction u = m_hat / (sqrt(v_hat) +
    eps) from two (mu, nu) after ``count`` steps: exact algebra, u1 - u2 =
    (m1 - m2) / (s2 + eps) + m1 (s2 - s1) / ((s1 + eps)(s2 + eps)), bounded
    by the triangle inequality."""
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    m1, m2 = mu1 / c1, mu2 / c1
    s1, s2 = (nu1 / c2).sqrt(), (nu2 / c2).sqrt()
    return ((m1 - m2).abs() / (s2 + eps)
            + m1.abs() * (s1 - s2).abs() / ((s1 + eps) * (s2 + eps)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small ops on one thread: a test run with several workers
    (tier-1 runs six) shares the host's cores among them, and a pool of
    torch threads in each spins against the others' (a test of a few seconds
    alone took minutes). The thread count is put back after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class MultiPair:
    """JAX's MultiSeedPPO and the port's on JAX's initial state."""

    def __init__(self, setup: str, seeds, freeze: bool = False, noise=None, **kwargs):
        args, port_cfg, self.shape, self.image = (
            (SMALL_JAX, small_port_config, (16, 16, 3), True) if setup == "slate"
            else (GT_JAX, gt_port_config, (5, 5), False))
        self.noise, self.S = noise, len(seeds)
        jpolicy, _, _, _ = jbuild_policy(jcompose("train_sb3", args), seed=0)
        if freeze:
            jpolicy = jpolicy.clone(freeze_ocr=True)
        with self.patched():
            self.j = JMultiSeedPPO(jpolicy, self.shape, self.image, 2,
                                   JPPOConfig(**kwargs), seeds, freeze_ocr=freeze)
        self.t = MultiSeedPPO([build_policy(port_cfg(), seed=s, device="cpu") for s in seeds],
                              self.shape, self.image, 2, tcfg.PPOConfig(**kwargs), seeds,
                              freeze_ocr=freeze, device="cpu")
        load_agent_tree(self.t, state_dict(self.j.save()))
        self.gap: dict = {}     # name -> lr x the summed Adam step gaps, [S, ...]
        self.t_noise = None if noise is None else torch.from_numpy(
            np.ascontiguousarray(np.broadcast_to(noise, (self.S,) + noise.shape)))

    @contextmanager
    def patched(self):
        with pytest.MonkeyPatch.context() as mp:
            if self.noise is not None:
                noise = self.noise
                mp.setattr(jax.random, "normal",
                           lambda key, shape, dtype=jnp.float32: jnp.asarray(
                               noise[tuple(slice(0, n) for n in shape)]))
            yield

    def update(self, data: dict, idx: np.ndarray):
        with self.patched(), jax.default_matmul_precision("highest"):
            self.j.params, self.j.opt_state, want = self.j._update(
                self.j.params, self.j.opt_state, {k: jnp.asarray(v) for k, v in data.items()},
                jnp.asarray(idx), jnp.asarray(self.j._np_key(self.S)))
        got = self.t.update_minibatch(self.t.upload(data), idx, self.t_noise)
        opt = self.t.optimizer
        count = int(opt.count[0])
        assert bool((opt.count == count).all())
        moments = [from_flax_stacked(_find(state_dict(self.j.opt_state), key))
                   for key in ("mu", "nu")]
        for name, mu, nu in zip(self.t.param_names, opt.mu, opt.nu):
            gap = opt.lr * adam_step_gap(mu, nu, moments[0][name], moments[1][name], count,
                                         opt.b1, opt.b2, opt.eps)
            self.gap[name] = self.gap.get(name, 0) + gap
        return ({k: v.numpy() for k, v in got.items()},
                {k: np.asarray(v) for k, v in want.items()})

    def check(self, got: dict, want: dict, state: bool = True) -> None:
        assert set(got) == set(want) == set(METRICS)
        for k in METRICS:
            assert np.all(np.abs(got[k] - want[k]) <= TOL * np.maximum(np.abs(want[k]),
                                                                       METRIC_FLOOR)), k
        if state:
            check_seeds(self.t, state_dict(self.j.params), state_dict(self.j.opt_state))
            return
        want = from_flax_stacked(state_dict(self.j.params))
        for name, w in want.items():     # parameters only: TOL plus the explained gaps
            err = (self.t.params[name] - w).abs()
            for i in range(self.S):
                bound = TOL * max(float(w[i].abs().max()), PARAM_FLOOR) + \
                    self.gap.get(name, torch.zeros_like(w))[i]
                assert bool((err[i] <= bound).all()), \
                    f"seed {i} parameter {name}: {float((err[i] / bound).max()):.3f} x its bound"


def check_seeds(t: MultiSeedPPO, params: dict, opt_state: dict) -> None:
    """Each seed's parameters and moments within TOL of JAX's (the floors
    of Pair.check)."""
    want = from_flax_stacked(params)
    moments = {key: from_flax_stacked(_find(opt_state, key)) for key in ("mu", "nu")}
    for i in range(t.S):
        close({k: v[i] for k, v in t.params.items()}, {k: v[i] for k, v in want.items()},
              f"seed {i} parameter", PARAM_FLOOR)
        for key, moment in moments.items():
            mine = dict(zip(t.param_names, getattr(t.optimizer, key)))
            top = max(float(v[i].abs().max()) for v in moment.values())
            close({k: v[i] for k, v in mine.items()}, {k: v[i] for k, v in moment.items()},
                  f"seed {i} {key}", top)


def stacked_rollout(S: int, n: int, shape, image, seeds=None) -> dict:
    per = [rollout(n, shape, image, seed) for seed in (seeds or range(1, S + 1))]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


@pytest.mark.parametrize("setup,freeze,seeds", [
    ("slate", False, [1, 2]), ("slate", True, [1, 2, 3]), ("gt", False, [1, 2, 3]),
    ("gt", False, [5, 5])], ids=["slate-e2e-2", "slate-frozen-3", "gt-3", "gt-identical"])
def test_multi_seed_updates_match_jax(setup, freeze, seeds):
    noise = slate_noise(4) if setup == "slate" else None
    pair = MultiPair(setup, seeds, freeze=freeze, noise=noise, batch_size=4)
    S = len(seeds)
    identical = len(set(seeds)) == 1
    data = stacked_rollout(S, 12, pair.shape, pair.image, [1] * S if identical else None)
    perms = np.stack([np.random.default_rng(2 if identical else 2 + i).permutation(12)
                      for i in range(S)]).reshape(S, 3, 4)
    pair.check(*pair.update(data, perms[:, 0]))
    for i in (1, 2):
        got, want = pair.update(data, perms[:, i])
    pair.check(got, want, state=not (setup == "slate" and not freeze))
    if identical:                     # positionally symmetric: the slots stay bitwise equal
        for k, v in pair.t.params.items():
            assert torch.equal(v[0], v[1]), k
        for t in pair.t.optimizer.mu + pair.t.optimizer.nu:
            assert torch.equal(t[0], t[1])


@pytest.mark.parametrize("setup", ["slate", "gt", "iodine"])
def test_multi_seed_update_matches_single_seed_ppos(setup):
    """IODINE's forward takes gradients of its own, so its multi-seed
    policy runs seed by seed (``vmappable`` False): the same check holds."""
    cfg, shape, image = {"slate": (small_port_config(), (16, 16, 3), True),
                         "gt": (gt_port_config(), (5, 5), False),
                         "iodine": (setup_tuple("iodine-transformer")[1](), (16, 16, 3),
                                    True)}[setup]
    seeds = [1, 2, 3]
    conf = tcfg.PPOConfig(batch_size=4)
    singles = [PPO(build_policy(cfg, seed=s, device="cpu"), shape, image, 2, conf, seed=s,
                   device="cpu") for s in seeds]
    multi = MultiSeedPPO([build_policy(cfg, seed=s, device="cpu") for s in seeds], shape,
                         image, 2, conf, seeds, device="cpu")
    assert multi.vmappable is (setup != "iodine")
    data = stacked_rollout(3, 8, shape, image)
    noise_shape = getattr(multi.policy.ocr_module, "noise_shape", None)
    noise = None if noise_shape is None else torch.from_numpy(np.stack([
        np.random.default_rng(10 + i).standard_normal(noise_shape(4)).astype(np.float32)
        for i in range(3)]))
    for step in range(2):
        idx = np.stack([np.random.default_rng(step * 3 + i).permutation(8)[:4]
                        for i in range(3)])
        got = multi.update_minibatch(multi.upload(data), idx, noise)
        for i, single in enumerate(singles):
            want = single.update_minibatch(single.upload({k: v[i] for k, v in data.items()}),
                                           torch.as_tensor(idx[i]),
                                           None if noise is None else noise[i])
            for k in METRICS:
                assert abs(got[k][i].item() - want[k].item()) <= \
                    TOL * max(abs(want[k].item()), METRIC_FLOOR), k
    for i, single in enumerate(singles):
        close({k: v[i] for k, v in multi.params.items()}, single.policy.state_dict(),
              "parameter", PARAM_FLOOR)
        for key in ("mu", "nu"):
            theirs = dict(zip(single.param_names, getattr(single.optimizer, key)))
            top = max(float(v.abs().max()) for v in theirs.values())
            close({n: v[i] for n, v in zip(multi.param_names, getattr(multi.optimizer, key))},
                  theirs, key, top)
        assert int(multi.optimizer.count[i]) == single.optimizer.count == 2


@pytest.mark.parametrize("mb", [8, 12])   # 8 divides n = 16, 12 does not
def test_target_kl_masks_each_seed_as_jax(mb):
    """A seed whose minibatch exceeds 1.5 x target_kl applies neither that
    update nor any later one, while the other keeps training; parameters
    and moments as JAX's after the same schedule."""
    pair = MultiPair("gt", [11, 22], batch_size=mb, n_epochs=2, target_kl=1e-12)
    data = stacked_rollout(2, 16, pair.shape, pair.image)
    logits, _ = jax.vmap(lambda p, o: pair.j.policy.apply({"params": p}, o))(
        pair.j.params, jnp.asarray(data["obs"]))
    logp = np.asarray(jax.nn.log_softmax(logits))
    data["logprobs"] = np.take_along_axis(logp, data["actions"][..., None].astype(np.int64),
                                          -1)[..., 0].astype(np.float32)
    data["logprobs"][0] += 5.0          # seed 0's first minibatch is over the limit
    before = {k: v.clone() for k, v in pair.t.params.items()}
    pair.j._np_rng = np.random.default_rng(7)
    pair.t._np_rng = np.random.default_rng(7)
    with jax.default_matmul_precision("highest"):
        pair.j.train_on_rollout({k: v.copy() for k, v in data.items()})
    metrics = pair.t.train_on_rollout({k: v.copy() for k, v in data.items()})
    assert all(torch.equal(v[0], before[k][0]) for k, v in pair.t.params.items())
    assert any(not torch.equal(v[1], before[k][1]) for k, v in pair.t.params.items())
    assert int(pair.t.optimizer.count[0]) == 0 and int(pair.t.optimizer.count[1]) >= 1
    assert metrics["approx_kl"][0] > 1.5e-12
    check_seeds(pair.t, state_dict(pair.j.params), state_dict(pair.j.opt_state))


def test_cached_frozen_reps_match_recomputed():
    """cache_frozen_reps: the rollout encoded once gives the updates of
    encoding every minibatch, for a deterministic frozen encoder."""
    cfg = setup_tuple("vae-mlp")[1]()
    seeds = [11, 22]

    def make(cache):
        return MultiSeedPPO([build_policy(cfg, seed=s, device="cpu") for s in seeds],
                            (16, 16, 3), True, 2, tcfg.PPOConfig(batch_size=8, n_epochs=2),
                            seeds, freeze_ocr=True, cache_frozen_reps=cache, device="cpu")

    plain, cached = make(False), make(True)
    assert cached.cache_reps and not plain.cache_reps
    data = stacked_rollout(2, 16, (16, 16, 3), True)
    got = {}
    for name, algo in (("plain", plain), ("cached", cached)):
        algo._np_rng = np.random.default_rng(7)
        got[name] = algo.train_on_rollout({k: v.copy() for k, v in data.items()})
    for i in range(2):
        close({k: v[i] for k, v in cached.params.items()},
              {k: v[i] for k, v in plain.params.items()}, "parameter", PARAM_FLOOR)
    for k in METRICS:
        assert np.all(np.abs(got["cached"][k] - got["plain"][k]) <=
                      TOL * np.maximum(np.abs(got["plain"][k]), METRIC_FLOOR)), k
    assert all(not n.startswith("ocr_module.") for n in cached.param_names)


class ScriptedEnvs:
    """A vec env of n scripted envs, each with its own numpy generator:
    observations, rewards, dones (about one step in five) and successes."""

    def __init__(self, n: int, seed: int):
        self.num_envs = n
        self.rngs = [np.random.default_rng(seed + i) for i in range(n)]

    def _obs(self, i):
        return self.rngs[i].random((5, 5)).astype(np.float32)

    def reset(self):
        return np.stack([self._obs(i) for i in range(self.num_envs)])

    def step_indices(self, indices, actions):
        out = []
        for i, a in zip(indices, actions):
            rng = self.rngs[i]
            done = bool(rng.random() < 0.2)
            reward = np.float32(rng.standard_normal() + int(a))
            info = {"is_success": bool(rng.random() < 0.5),
                    "terminal_observation": np.zeros((5, 5))} if done else {}
            out.append((self._obs(i), reward, done, info))
        obs, rewards, dones, infos = zip(*out)
        return np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones), list(infos)

    def step(self, actions):
        return self.step_indices(range(self.num_envs), actions)


def scripted(obs: np.ndarray):
    """(action, log-probability, value) [S, e] of observations [S, e, 5, 5]."""
    total = obs.reshape(obs.shape[:2] + (-1,)).sum(-1)
    action = ((np.floor(total * 1000).astype(np.int64) + 1) % 4)
    return action, (-0.01 * total).astype(np.float32), obs.mean((2, 3)).astype(np.float32)


def scripted_pair(seeds, E):
    pair = MultiPair("gt", seeds)
    j, t = pair.j, pair.t
    j.num_envs = t.num_envs = E

    def packed(obs):
        a, lp, v = scripted(np.asarray(obs))
        return np.stack([a.astype(np.float32), lp, v], axis=1)

    j._act_packed = lambda params, obs, keys, step: packed(obs)
    j._act = lambda params, obs, keys: scripted(np.asarray(obs))
    j._values = lambda params, obs, key: scripted(np.asarray(obs))[2]
    j._act_det = lambda params, obs, keys: scripted(np.asarray(obs))[0]
    t.act_device = lambda obs: torch.from_numpy(packed(obs))
    t.values_host = lambda obs: scripted(np.asarray(obs))[2]
    t.act_deterministic_device = lambda obs: torch.from_numpy(scripted(np.asarray(obs))[0])
    return j, t


@pytest.mark.parametrize("kind", ["collect_rollout", "collect_rollout_deep",
                                  "collect_rollout_pipelined"])
def test_rollouts_and_gae_match_jax(kind):
    S, E, T = 2, 4, 9
    j, t = scripted_pair([11, 22], E)
    calls = {"jax": 0, "port": 0}
    jenv, tenv = ScriptedEnvs(S * E, 3), ScriptedEnvs(S * E, 3)
    want = getattr(j, kind)(jenv, jenv.reset(), T,
                            lambda a: calls.__setitem__("jax", calls["jax"] + 1))
    got = getattr(t, kind)(tenv, tenv.reset(), T,
                           lambda a: calls.__setitem__("port", calls["port"] + 1))
    np.testing.assert_array_equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for key in want[1]:
        np.testing.assert_array_equal(got[1][key], want[1][key], err_msg=key)
        assert got[1][key].dtype == want[1][key].dtype and got[1][key].shape[:2] == (S, T * E)
    assert [[i["is_success"] for i in seed] for seed in got[2]] == \
        [[i["is_success"] for i in seed] for seed in want[2]]
    assert sum(len(seed) for seed in want[2]) > 0
    assert t.num_timesteps == j.num_timesteps == S * E * T and calls["jax"] == calls["port"] == T


def test_evaluate_all_matches_jax():
    seeds, E = [11, 22], 3
    j, t = scripted_pair(seeds, E)
    jcfg = jcompose("train_sb3", GT_JAX[:-1] + ["env=target-N4C4S3S1",
                                                "env.render_mode=state"]).env
    cfg = tcfg.replace(tcfg.read_env_config("target-N4C4S3S1"), "render_mode", "state")
    jenv = jmake_multi_seed_vec_env(jenvs.TargetEnv, jcfg, E, seeds, mode="dummy")
    tenv = make_multi_seed_vec_env(make_env, cfg, E, seeds, mode="dummy")
    want = j.evaluate_all(jenv, n_episodes=5, deterministic=True)
    got = t.evaluate_all(tenv, n_episodes=5, deterministic=True)
    assert got == want and len(got) == 2


AGENTS = {"odd-one-out-N4C2S2S1": "GT-Transformer-PPO-OddOneOutN4C2S2S1Env-final",
          "push-N3C4S1S1": "GT-Transformer-PPO-PushN3C4S1S1Env-final"}


@pytest.mark.parametrize("env", AGENTS)
def test_test_sb3_seeds_matches_jax_evaluate_all(env):
    """test_sb3 seeds= (argmax actions) on a committed stacked GT agent: the
    file's three seeds, each on its own envs seeded s + 200000, against
    JAX's evaluate_all on the same file and envs."""
    path = ROOT / "artifacts" / "rl" / AGENTS[env]
    argv = ["ocr=gt", "pooling=transformer", "pooling.num_layers=3", "sb3=ppo",
            "sb3_acnet=mlp", f"env={env}", "seeds=1234,2345,3456", "n_eval_episodes=6",
            f"agent_checkpoint.file={path}"]
    got = test_sb3.evaluate_seeds(tcfg.compose(tcfg.TestSB3Config(), argv), "cpu",
                                  deterministic=True)
    jcfg = jcompose("test_sb3", argv[:6])
    jcfg.env.render_mode = "state"
    seeds = [1234, 2345, 3456]
    jenv = jmake_multi_seed_vec_env(getattr(jenvs, jcfg.env.env), jcfg.env, 6,
                                    [s + 200000 for s in seeds], mode="dummy")
    jpolicy, _, freeze, _ = jbuild_policy(jcfg, seed=0)
    j = JMultiSeedPPO(jpolicy, jenv.observation_space.shape, False, 6, JPPOConfig(), seeds,
                      freeze_ocr=freeze)
    tree, _ = jload_checkpoint(f"{path}.ckpt", j.save(), allow_partial=True)
    j.load(tree)
    with jax.default_matmul_precision("highest"):
        want = j.evaluate_all(jenv, n_episodes=6, deterministic=True)
    assert got["per_seed"] == {f"seed{s}": m for s, m in zip(seeds, want)}
    assert got["summary"]["success_rate"]["mean"] == pytest.approx(
        np.mean([m["success_rate"] for m in want]))


def test_learn_seed_view_and_save_load():
    seeds = [11, 22]
    cfg = tcfg.replace(gt_port_config("target-N4C4S3S1"), "env.render_mode", "state")
    vec = make_multi_seed_vec_env(make_env, cfg.env, 4, seeds, mode="dummy")
    algo = MultiSeedPPO([build_policy(cfg, seed=s, device="cpu") for s in seeds], (5, 5),
                        False, 4, tcfg.PPOConfig(n_steps=16, batch_size=8, n_epochs=2), seeds,
                        pipeline=True, device="cpu")
    assert algo.pipeline
    iterations = []
    algo.learn(vec, 32, iteration_callback=lambda a, m, infos: iterations.append(
        (m, [len(i) for i in infos])))
    assert algo.num_timesteps == 64 and len(iterations) == 2
    assert all(m[k].shape == (2,) and np.isfinite(m[k]).all() for m, _ in iterations
               for k in METRICS)
    obs0 = vec.reset()[0]
    view = algo.seed_view(1)
    assert len({int(view.predict(obs0, deterministic=True)) for _ in range(4)}) == 1
    assert all(int(view.predict(obs0, deterministic=False)) in range(4) for _ in range(8))
    saved = algo.save()
    algo.update_minibatch(algo.upload(stacked_rollout(2, 8, (5, 5), False)),
                          np.stack([np.arange(4)] * 2))
    algo.load(saved)
    assert all(torch.equal(v, saved["policy_params"][k]) for k, v in algo.params.items())
    assert int(algo.optimizer.count.max()) == 8 and algo.num_timesteps == 64
    with pytest.raises(ValueError, match="seeds"):
        algo.load(dict(saved, seeds=[1, 2]))
    vec.close()


def _sweep_inputs(S=3, B=2, N=37, K=5, D=32):
    rng = np.random.default_rng(3)
    k = torch.from_numpy((rng.standard_normal((S, B, N, D)) * D ** -0.5).astype(np.float32))
    v, q = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((S, B, N, D), (S, B, K, D)))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((S, B, K), (S, B, K, D), (S, B, N, K))]
    return k, v, q, w


def _loss(sweep):
    def loss(k, v, q, w_sa, w_av, w_a):
        sa, av, a = sweep(k, v, q)
        return (sa * w_sa).sum() + (av * w_av).sum() + (a * w_a).sum()
    return loss


def test_route_sweep_under_torch_func_on_the_cpu():
    k, v, q, w = _sweep_inputs()
    outs = vmap(tsr.route_sweep)(k, v, q)
    grads = vmap(grad(_loss(tsr.route_sweep), argnums=(0, 1, 2)))(k, v, q, *w)
    shared = vmap(tsr.route_sweep, in_dims=(None, 0, 0))(k[0], v, q)
    for i in range(3):
        want = tsr.route_sweep(k[i], v[i], q[i])
        leaves = [x[i].clone().requires_grad_() for x in (k, v, q)]
        want_grads = torch.autograd.grad(_loss(tsr.route_sweep)(*leaves, *(x[i] for x in w)),
                                         leaves)
        one_grad = grad(_loss(tsr.route_sweep), argnums=(0, 1, 2))(k[i], v[i], q[i],
                                                                   *(x[i] for x in w))
        for g, x in zip((*outs, *grads, *one_grad), (*want, *want_grads, *want_grads)):
            torch.testing.assert_close(g[i] if g.dim() == x.dim() + 1 else g, x,
                                       rtol=1e-6, atol=1e-6)
        for g, x in zip(shared, tsr.route_sweep(k[0], v[i], q[i])):
            torch.testing.assert_close(g[i], x, rtol=1e-6, atol=1e-6)


def test_sweep_vmap_rule_folds_the_seeds_into_one_launch(monkeypatch):
    """The vmap rules of the sweep's two Functions, with the kernels' launches
    replaced by plain versions that refuse torch.func's wrapped tensors: one
    launch at S * B rows for the forward, one for the backward under
    vmap(grad), an unbatched input expanded; the results those of the plain
    sweep."""
    launches = []

    def plain(*tensors):
        for t in tensors:
            assert not torch._C._functorch.is_functorch_wrapped_tensor(t)
            t.data_ptr()

    def fwd(k, v, q, heads=1):
        plain(k, v, q)
        launches.append(("fwd", k.shape[0]))
        with torch.no_grad():
            return tsr.route_sweep_reference(k, v, q, heads)

    def bwd(k, v, q, a, g_av, g_a, heads=1):
        plain(k, v, q, a, g_av, g_a)
        launches.append(("bwd", k.shape[0]))
        leaves = [x.detach().requires_grad_() for x in (k, v, q)]
        with torch.enable_grad():
            _, av, a2 = tsr.route_sweep_reference(*leaves, heads)
            return torch.autograd.grad((av, a2), leaves, (g_av, g_a))

    monkeypatch.setattr(tsr, "_sweep_fwd", fwd)
    monkeypatch.setattr(tsr, "_sweep_bwd", bwd)
    k, v, q, w = _sweep_inputs()
    outs = vmap(tsr._RouteSweep.apply)(k, v, q)
    assert launches == [("fwd", 6)]
    launches.clear()
    grads = vmap(grad(_loss(tsr._RouteSweep.apply), argnums=(0, 1, 2)))(k, v, q, *w)
    assert launches == [("fwd", 6), ("bwd", 6)]
    launches.clear()
    shared = vmap(tsr._RouteSweep.apply, in_dims=(None, 0, 0))(k[0], v, q)
    assert launches == [("fwd", 6)]
    want_grads = vmap(grad(_loss(tsr.route_sweep_reference), argnums=(0, 1, 2)))(k, v, q, *w)
    for g, x in zip((*outs, *grads), (*vmap(tsr.route_sweep_reference)(k, v, q),
                                       *want_grads)):
        torch.testing.assert_close(g, x, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(shared[1], vmap(tsr.route_sweep_reference, in_dims=(None, 0, 0))(
        k[0], v, q)[1], rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tsr._SweepBackward.backward(None)
