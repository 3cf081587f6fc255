"""The port's CausalWorld reach envs (fake TriFinger backend) against the
JAX package's (the reference, in the same process):

- episodes bitwise equal under the same seeds and actions, in the state,
  image and finger_image modes, the target and ooo tasks, the easy and
  hard modes: observations, rewards, dones and every info key, over two
  envs of one in-process vec env (they share numpy's global stream), past
  an auto-reset, with one env steered onto its target;
- the forked vec env's Box actions, each env against the env alone;
- the Pillow resize against PIL, the colour table against matplotlib, the
  YAML reader against ``compose`` for the six ``cw-*`` files;
- the one deliberate divergence: JAX's backend raises ``TypeError`` on
  ``render("rgb_array")``, the port's returns the pixels of JAX's
  ``render()``;
- the collector's file (read with h5py) against JAX's workers with
  gymnasium's ``Box.sample`` patched to the same draws.
"""

import sys
from pathlib import Path

import gymnasium
import h5py
import numpy as np
import pytest
from matplotlib import colors as mpl_colors
from PIL import Image

import ocrl_tpu.envs as jenvs
from ocrl_tpu.config import compose
from ocrl_tpu.envs.cw_sim import FLOOR_HEIGHT, cart2cyl
from ocrl_tpu.rl.vec_env import VecEnv as JVecEnv

from ocrl_tpu_torch import collect_dataset_from_cw_envs as tcollect
from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.envs import cw as tcw
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.envs.resize import resize_bilinear
from ocrl_tpu_torch.rl.vec_env import SubprocVecEnv, VecEnv

ROOT = Path(__file__).resolve().parents[1]
CW = sorted(p.stem for p in (ROOT / "configs" / "env").glob("cw-*.yaml"))
STEPS = 130                       # past the 100-step episode end


def jax_env_config(name: str, *over: str):
    return compose("train_sb3", ["ocr=gt", "pooling=mlp", "sb3=sac", "sb3_acnet=mlp",
                                 f"env={name}", "env.use_fake_sim=true", *over]).env


def port_env_config(name: str, render_mode: str | None = None):
    cfg = tcfg.replace(tcfg.read_env_config(name), "use_fake_sim", True)
    return cfg if render_mode is None else tcfg.replace(cfg, "render_mode", render_mode)


def oracle_action(env) -> np.ndarray:
    """Joint targets that put finger 1 on the target (the inverse of the fake
    kinematics, as tests/test_cw.py)."""
    while hasattr(env, "env"):
        env = env.env
    r, theta, z = cart2cyl(env.stage.get_object_state(env.task.target_obj,
                                                      "cartesian_position"))
    base = 2 * np.pi / 3
    dtheta = np.arctan2(np.sin(theta - base), np.cos(theta - base))
    return np.array([dtheta / 0.6, (r - 0.02) / 0.05 - 1.56,
                     (z - FLOOR_HEIGHT) * 2.7 / 0.12 - 2.7], np.float32)


def run(vec, actions, steer_env0: bool) -> list:
    """(obs, rewards, dones, infos) of the reset and of each step."""
    out = [vec.reset()]
    for a in actions:
        a = a.copy()
        if steer_env0:
            a[0] = oracle_action(vec.envs[0])
        out.append(vec.step(a))
    return out


def assert_same(got, want) -> None:
    """Equal arrays (bitwise, same dtype), numbers and dicts of them."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (got, want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (got, want)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want, (got, want)


@pytest.mark.parametrize("name,mode", [
    ("cw-target-N4C4S1S1", "image"), ("cw-target-N4C4S1S1", "state"),
    ("cw-target-N4C4S1S1-hard", "image"), ("cw-ooo-N4C3S1S1", "state"),
    ("cw-notarget-N4C11S1S1-hard", "state"), ("cw-fingerimg-target-N4C4S1S1", None),
    ("cw-fingerimg-notarget-N4C11S1S1-hard", None)])
def test_episodes_match_jax_bitwise(name, mode):
    over = [] if mode is None else [f"env.render_mode={mode}"]
    jcfg = jax_env_config(name, *over)
    tcfg_ = port_env_config(name, mode)
    steps = STEPS if mode == "state" else 30       # rendering: env 0's resets suffice
    actions = np.random.default_rng(3).uniform(-1, 1, (steps, 2, 3)).astype(np.float32)
    want = run(JVecEnv([lambda s=s: jenvs.CwTargetEnv(jcfg, s) for s in (7, 8)]), actions,
               steer_env0=True)
    got = run(VecEnv([lambda s=s: make_env(tcfg_, s) for s in (7, 8)]), actions,
              steer_env0=True)
    assert_same(got, want)
    rewards = np.stack([w[1] for w in want[1:]])
    dones = np.stack([w[2] for w in want[1:]])
    assert rewards[:, 0].sum() > 0 and dones[:, 0].sum() >= 2     # steered: reached, reset
    assert dones[:, 1].any() == (steps > 100)                    # the 100-step end


def test_forked_vec_env_takes_box_actions():
    cfg = port_env_config("cw-target-N4C4S1S1-hard", "state")
    actions = np.random.default_rng(4).uniform(-1, 1, (40, 2, 3)).astype(np.float32)
    vec = SubprocVecEnv([lambda s=s: make_env(cfg, s) for s in (1, 2)])
    try:
        got = run(vec, actions, steer_env0=False)
    finally:
        vec.close()
    for i, seed in enumerate((1, 2)):
        alone = run(VecEnv([lambda: make_env(cfg, seed)]), actions[:, i:i + 1],
                    steer_env0=False)
        assert_same([g[i] if j == 0 else tuple(x[i] for x in g) for j, g in enumerate(got)],
                    [a[0] if j == 0 else tuple(x[0] for x in a) for j, a in enumerate(alone)])


@pytest.mark.parametrize("size", [256, 128, 53])
def test_resize_matches_pil_bitwise(size):
    rng = np.random.default_rng(size)
    for _ in range(3):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((64, 64), Image.BILINEAR))
        assert_same(resize_bilinear(img, 64, 64), want)
    img = rng.integers(0, 256, (size, 2 * size, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((40, 17), Image.BILINEAR))
    assert_same(resize_bilinear(img, 17, 40), want)


def test_colour_table_matches_matplotlib():
    names = {c for name in CW for c in tcfg.read_env_config(name).COLORS}
    assert len(names) == 11 and set(tcw.CW_RGB) == names
    for c in names:
        assert tcw.to_rgb(c) == mpl_colors.to_rgb(c), c
    assert tcw.to_rgb("green") == (0.0, 128 / 255, 0.0)
    with pytest.raises(ValueError, match="colour 'teal'"):
        tcw.to_rgb("teal")


@pytest.mark.parametrize("name", CW)
def test_read_env_config_matches_compose(name):
    want = compose("train_sb3", ["ocr=gt", "pooling=mlp", "sb3=sac", "sb3_acnet=mlp",
                                 f"env={name}"]).env.to_dict()
    got = tcfg.read_env_config(name)
    assert isinstance(got, tcfg.CwEnvConfig)
    have = {k: list(v) if isinstance(v, tuple) else v
            for k, v in tcfg.dataclasses.asdict(got).items()}
    assert have == want


def test_render_takes_a_mode_where_jax_raises():
    action = np.array([0.3, -0.2, 0.5], np.float32)
    jenv = jenvs.CwTargetEnv(jax_env_config("cw-target-N4C4S1S1"), 5)
    jenv.reset(), jenv.step(action)          # one after the other: numpy's global stream
    tenv = make_env(port_env_config("cw-target-N4C4S1S1"), 5)
    tenv.reset(), tenv.step(action)
    with pytest.raises(TypeError, match="positional argument"):
        jenv.render("rgb_array")
    frame = tenv.render("rgb_array")
    assert frame.shape == (256, 256, 3)
    assert_same(frame, jenv.render())
    assert_same(tenv.render(), jenv.render())


def test_real_simulator_is_not_ported():
    with pytest.raises(ImportError, match="causal_world"):
        make_env(tcfg.read_env_config("cw-target-N4C4S1S1"), 0)
    with pytest.raises(ImportError, match="causal_world"):
        jenvs.CwTargetEnv(compose("train_sb3", ["ocr=gt", "pooling=mlp", "sb3=sac",
                                                "sb3_acnet=mlp",
                                                "env=cw-target-N4C4S1S1"]).env, 0)


@pytest.mark.parametrize("name,channels", [("cw-notarget-N4C11S1S1-hard", 3),
                                           ("cw-fingerimg-target-N4C4S1S1", 9)])
def test_collector_matches_jax_workers(name, channels, tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    import collect_dataset_from_cw_envs as jcollect

    out = tmp_path / "cw.hdf5"
    tcollect.main(["--env", name, "--num-tr", "25", "--num-val", "7", "--num-proc", "2",
                   "--fake-sim", "--out", str(out)])
    cfg = jax_env_config(name)
    with h5py.File(out, "r") as f:
        for split, total in (("TrainingSet", 25), ("ValidationSet", 7)):
            parts = []
            for i, count in enumerate([total // 2 + total % 2, total // 2]):
                rng = np.random.default_rng(1000 * i)
                monkeypatch.setattr(gymnasium.spaces.Box, "sample",
                                    lambda self, mask=None, rng=rng: rng.uniform(
                                        self.low, self.high, self.shape).astype(self.dtype))
                parts.append(jcollect._worker((cfg.env, cfg.to_dict(), 1000 * i, count)))
            want = {k: np.concatenate([p[j] for p in parts])
                    for j, k in enumerate(("obss", "num_objs", "labels"))}
            assert set(f[split]) == set(want)
            for key, value in want.items():
                assert_same(f[split][key][()], value)
            assert want["obss"].shape == (total, 64, 64, channels)
