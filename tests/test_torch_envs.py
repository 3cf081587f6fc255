"""The port's synthetic envs against the JAX package's (the reference, in the
same process): the same seed and the same numpy-drawn actions give
bitwise-equal observations and equal rewards, dones and ``is_success``,
auto-reset included; the colour table against matplotlib; the YAML reader
against ``ocrl_tpu.config.compose`` on every synthetic env file; the
in-process vec env against the forked one."""

from pathlib import Path

import numpy as np
import pytest
from matplotlib import colors as mpl_colors

import ocrl_tpu.envs as jenvs
from ocrl_tpu.config import compose
from ocrl_tpu.config.compose import _yaml_load
from ocrl_tpu.rl.vec_env import VecEnv as JVecEnv

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.envs import base as tbase
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.rl.vec_env import SubprocVecEnv, VecEnv, make_vec_env

ROOT = Path(__file__).resolve().parents[1]
SYNTHETIC = sorted(p.stem for p in (ROOT / "configs" / "env").glob("*.yaml")
                   if not p.stem.startswith(("_", "cw-")))
ENVS = ["target-N4C4S3S1", "odd-one-out-N4C2S2S1", "odd-one-out-N4C2S2S1-oc",
        "push-N3C4S1S1", "maze-N4C4S4S2", "random-N5C4S4S2"]
STEPS = 300


def jax_env_config(name: str, render_mode: str = "image"):
    cfg = compose("train_sb3", ["ocr=gt", "pooling=transformer", "sb3=ppo",
                                "sb3_acnet=mlp", f"env={name}",
                                f"env.render_mode={render_mode}"])
    return cfg.env


def _typed(x):
    """Values with their types, so that 1 and 1.0 differ."""
    if isinstance(x, dict):
        return {k: _typed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_typed(v) for v in x]
    return (type(x).__name__, x)


def test_every_synthetic_env_file_is_covered():
    assert len(SYNTHETIC) >= 90 and set(ENVS) <= set(SYNTHETIC)


@pytest.mark.parametrize("name", SYNTHETIC)
def test_yaml_reader_matches_compose(name):
    want = jax_env_config(name).to_dict()
    got = tcfg.compose_file(tcfg.CONFIG_DIR / "env" / f"{name}.yaml")
    assert _typed(got) == _typed(want)
    env = tcfg.read_env_config(name)
    for key, value in want.items():
        if key in {f for f in tcfg.SyntheticEnvConfig.__dataclass_fields__}:
            have = getattr(env, key)
            if key == "background":
                have = {"img_paths": list(have.img_paths), "use_bg": have.use_bg}
            elif isinstance(have, tuple):
                have = [list(v) if isinstance(v, tuple) else v for v in have]
            assert _typed(have) == _typed(value), key


@pytest.mark.parametrize("text", ["3e-2", "2e6", "1e-4", "0.15", "-1", "+5", "1_000",
                                  "5.", ".5", "null", "~", "None", "''", '"a b"',
                                  "'it''s'", "yes", "Off", "true", "False", "image",
                                  "[blue, [red, 0.15], 'x', 3e-2, null, []]", "[]",
                                  "../dtd/images/braided"])
def test_scalar_reader_matches_yaml(text):
    assert _typed(tcfg.parse_scalar(text)) == _typed(_yaml_load(text))


def test_colour_table_matches_matplotlib():
    names = set()
    for name in SYNTHETIC:
        env = jax_env_config(name)
        names |= set(env.COLORS) | {env.AGENT[0]} | set(env.unseen_combi)
        names |= {v for v in env.get("target", []) if isinstance(v, str)
                  and v not in tbase.SHAPES}
    assert names <= set(tbase.RGB255)
    for name in tbase.RGB255:
        assert tbase.RGB255[name] == tuple(int(c * 255) for c in mpl_colors.to_rgb(name))


def _drive(vec_env, actions):
    """(obs, rewards, dones, is_success, terminal observations) of a run of
    ``actions`` [T, E] from reset."""
    out = {"obs": [vec_env.reset()], "rewards": [], "dones": [], "success": [],
           "terminal": []}
    for act in actions:
        obs, rewards, dones, infos = vec_env.step(act)
        out["obs"].append(obs)
        out["rewards"].append(rewards)
        out["dones"].append(dones)
        out["success"].append([bool(i["is_success"]) for i in infos])
        out["terminal"] += [i["terminal_observation"] for i in infos
                            if "terminal_observation" in i]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("render_mode", ["image", "state"])
@pytest.mark.parametrize("name", ENVS)
def test_episodes_match_jax(name, render_mode):
    actions = np.random.default_rng(7).integers(0, 4, (STEPS, 2))
    jcfg = jax_env_config(name, render_mode)
    jax_cls = getattr(jenvs, jcfg.env)
    want = _drive(JVecEnv([lambda s=s: jax_cls(jcfg, s) for s in (11, 12)]), actions)
    tcfg_env = tcfg.replace(tcfg.read_env_config(name), "render_mode", render_mode)
    got = _drive(VecEnv([lambda s=s: make_env(tcfg_env, s) for s in (11, 12)]), actions)
    assert got["dones"].sum() >= 2            # auto-reset was exercised
    assert got["obs"].dtype == want["obs"].dtype
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_masks_match_jax():
    jcfg = jax_env_config("target-N4C4S3S1")
    jenv = jenvs.TargetEnv(jcfg, 3)
    env = make_env(tcfg.read_env_config("target-N4C4S3S1"), 3)
    jenv.reset()
    env.reset()
    np.testing.assert_array_equal(env.render("mask"), jenv.render("mask"))


def test_subproc_vec_env_matches_in_process():
    cfg = tcfg.read_env_config("odd-one-out-N4C2S2S1")
    actions = np.random.default_rng(3).integers(0, 4, (120, 3))
    want = _drive(VecEnv([lambda s=s: make_env(cfg, s) for s in (5, 6, 7)]), actions)
    sub = make_vec_env(make_env, cfg, 3, seed=5, mode="subproc")
    try:
        assert isinstance(sub, SubprocVecEnv)
        assert sub.observation_space.shape == (64, 64, 3)
        assert sub.action_space.n == 4
        got = _drive(sub, actions)
    finally:
        sub.close()
    assert all(not p.is_alive() for p in sub.procs)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_spaces_match_jax():
    for name in ("push-N3C4S1S1", "target-N4C4S3S1"):
        for mode in ("image", "state"):
            jenv = getattr(jenvs, jax_env_config(name).env)(jax_env_config(name, mode), 0)
            env = make_env(tcfg.replace(tcfg.read_env_config(name), "render_mode", mode), 0)
            for space in ("observation_space", "action_space"):
                j, t = getattr(jenv, space), getattr(env, space)
                assert t.shape == j.shape and t.dtype == j.dtype
            assert env.action_space.n == jenv.action_space.n
            np.testing.assert_array_equal(env.observation_space.high,
                                          jenv.observation_space.high)


def test_later_slices_raise():
    """Background images are still refused; the CausalWorld envs are ported
    (tests/test_torch_cw.py), and an env no config names raises."""
    with pytest.raises(NotImplementedError, match="background"):
        make_env(tcfg.replace(tcfg.read_env_config("target-N4C4S3S1"),
                              "background.use_bg", True), 0)
    assert isinstance(tcfg.read_env_config("cw-target-N4C4S1S1"), tcfg.CwEnvConfig)
    with pytest.raises(ValueError, match="unknown env 'CwReachEnv'"):
        make_env(tcfg.replace(tcfg.read_env_config("target-N4C4S3S1"), "env", "CwReachEnv"),
                 0)
