"""train_sb3's run files in the port against the JAX package (the reference,
in the same process):

- ``convert.to_flax`` is the exact inverse of ``from_flax`` for the policy
  of every OCR and pooling the port builds, and gives JAX's own tree back;
- agent files both ways: a file the port wrote (PPO and A2C on GT, PPO
  with SLATE's OCR frozen, a multi-seed PPO end to end and frozen) restores
  in JAX's ``load_checkpoint(path, algo.save())`` through flax's strict
  ``from_bytes`` and holds the port's state bitwise; a file JAX wrote after
  its own updates resumes the port bitwise (parameters, moments, count,
  num_timesteps), and the port writes it back unchanged; a seeds mismatch
  raises as JAX's ``MultiSeedPPO.load`` does; a params-only file loads with
  ``allow_partial`` and raises without;
- GIFs: decoded by PIL and by imageio, equal to the recorded frames when
  they hold at most 256 colours, and to the stated nearest-palette rule
  otherwise; the recorder's file names are JAX's VideoRecorder's for the
  same sequence of num_timesteps;
- the whole cycle of tests/test_cli_e2e.py:57 through the port's entry
  points on the CPU at GT: train_sb3 seeds=11,22, resumed, then test_sb3
  seeds=, its files and metric names; compose takes seeds, resume and
  video and still refuses sb3=sac.
"""

import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from ocrl_tpu.config import compose as jcompose
from ocrl_tpu.rl import A2C as JA2C
from ocrl_tpu.rl import PPO as JPPO
from ocrl_tpu.rl import A2CConfig as JA2CConfig
from ocrl_tpu.rl import PPOConfig as JPPOConfig
from ocrl_tpu.rl import build_policy as jbuild_policy
from ocrl_tpu.rl.multi_seed import MultiSeedPPO as JMultiSeedPPO
from ocrl_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from ocrl_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import test_sb3, train_sb3
from ocrl_tpu_torch.rl import A2C, PPO, MultiSeedPPO, VideoRecorder, build_policy
from ocrl_tpu_torch.utils import gif
from ocrl_tpu_torch.utils.checkpoint import (agent_tree, load_agent_tree, load_algo,
                                             load_checkpoint, save_algo)
from ocrl_tpu_torch.utils.convert import (attention_heads, from_flax, from_flax_stacked,
                                          to_flax)

from test_torch_models import SMALL_JAX, small_port_config
from test_torch_rl import GT_JAX, gt_port_config, rollout
from test_torch_rl_ocrs import SETUPS as OCR_SETUPS
from test_torch_rl_ocrs import setup_tuple


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


def same(a, b) -> bool:
    """Equal nested dicts of arrays and numbers, bitwise and in dtype."""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and set(a) == set(b) and \
            all(same(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def state_dict(tree) -> dict:
    return jax.tree.map(np.asarray, serialization.to_state_dict(jax.device_get(tree)))


POOLINGS = [["pooling=transformer", "pooling.d_model=32", "pooling.nhead=4"],
            ["pooling=rn"], ["pooling=mlp"], ["pooling=identity", "sb3_acnet=identity"],
            ["pooling=transformer", "pooling.d_model=32", "pooling.nhead=4",
             "pooling.use_mlp2=True"]]


@pytest.mark.parametrize("name", list(OCR_SETUPS) + ["slate", "gt"])
def test_to_flax_inverts_from_flax_for_every_ocr(name):
    """from_flax(to_flax(state)) is the state, every pooling with the OCR."""
    if name == "slate":
        cfgs = [small_port_config()]
    elif name == "gt":
        cfgs = [tcfg.compose(tcfg.TrainSB3Config(), ["ocr=gt", "env=push-N3C4S1S1"] + p)
                .policy_config() for p in POOLINGS]
    else:
        cfgs = [setup_tuple(name)[1]()]
    for cfg in cfgs:
        policy = build_policy(cfg, seed=3, device="cpu")
        state = policy.state_dict()
        back = from_flax(to_flax(state, attention_heads(policy)))
        assert set(back) == set(state)
        for k, v in state.items():
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("setup", ["slate", "gt", "mae-transformer"])
def test_to_flax_gives_jax_tree(setup):
    """JAX's own parameter tree through from_flax and back is that tree
    (the OCRs' own layouts, MultipleCNN's stacking among them, are held to
    JAX's by tests/test_torch_train_ocr.py)."""
    args = {"slate": SMALL_JAX, "gt": GT_JAX}.get(setup) or setup_tuple(setup)[0]
    jpolicy, _, _, _ = jbuild_policy(jcompose("train_sb3", args), seed=0)
    shape = (5, 5) if setup == "gt" else (16, 16, 3)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(["params", "noise", "noise2",
                                                          "dropout"])}
    params = jax.jit(jpolicy.init)(rngs, jnp.zeros((1,) + shape))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = {"slate": small_port_config, "gt": gt_port_config}.get(setup) or \
        setup_tuple(setup)[1]
    policy = build_policy(cfg(), seed=0, device="cpu")
    policy.load_state_dict(from_flax(params))
    assert same(to_flax(policy.state_dict(), attention_heads(policy)), dict(params))


SEEDS = [3, 4]


def make_pair(kind: str):
    """(JAX algorithm, the port's on JAX's initial state, obs shape, image
    observations, A2C)."""
    slate = kind in ("ppo-frozen", "multi-frozen")
    args, port_cfg, shape, image = (SMALL_JAX, small_port_config, (16, 16, 3), True) if slate \
        else (GT_JAX, gt_port_config, (5, 5), False)
    jpolicy, _, _, _ = jbuild_policy(jcompose("train_sb3", args), seed=0)
    frozen = kind.endswith("frozen")
    if frozen:
        jpolicy = jpolicy.clone(freeze_ocr=True)
    if kind.startswith("multi"):
        j = JMultiSeedPPO(jpolicy, shape, image, 2, JPPOConfig(batch_size=4), SEEDS,
                          freeze_ocr=frozen)
        t = MultiSeedPPO([build_policy(port_cfg(), seed=s, device="cpu") for s in SEEDS],
                         shape, image, 2, tcfg.PPOConfig(batch_size=4), SEEDS,
                         freeze_ocr=frozen, device="cpu")
    elif kind == "a2c":
        j = JA2C(jpolicy, shape, image, 2, JA2CConfig(), seed=0)
        t = A2C(build_policy(port_cfg(), seed=0, device="cpu"), shape, image, 2,
                tcfg.A2CConfig(), device="cpu")
    else:
        j = JPPO(jpolicy, shape, image, 2, JPPOConfig(batch_size=4), seed=0, freeze_ocr=frozen)
        t = PPO(build_policy(port_cfg(), seed=0, device="cpu"), shape, image, 2,
                tcfg.PPOConfig(batch_size=4), freeze_ocr=frozen, device="cpu")
    load_agent_tree(t, state_dict(j.save()))
    return j, t, shape, image


KINDS = ["ppo", "a2c", "ppo-frozen", "multi", "multi-frozen"]


def port_updates(t, shape, image):
    if isinstance(t, MultiSeedPPO):
        batch = {k: np.stack([v, v[::-1]]) for k, v in rollout(8, shape, image, 1).items()}
        data = t.upload(batch)
        for i in range(2):
            t.update_minibatch(data, np.stack([np.arange(4) + 4 * i, np.arange(4)]))
    elif isinstance(t, A2C):
        t.train_on_rollout(rollout(8, shape, image, 1))
        t.train_on_rollout(rollout(8, shape, image, 2))
    else:
        data = t.upload(rollout(8, shape, image, 1))
        for i in range(2):
            t.update_minibatch(data, torch.arange(4) + 4 * i)


def jax_updates(j, shape, image):
    if isinstance(j, JMultiSeedPPO):
        batch = {k: jnp.asarray(np.stack([v, v[::-1]]))
                 for k, v in rollout(8, shape, image, 1).items()}
        for i in range(2):
            idx = jnp.asarray(np.stack([np.arange(4) + 4 * i, np.arange(4)]))
            j.params, j.opt_state, _ = j._update(j.params, j.opt_state, batch, idx,
                                                 jnp.asarray(j._np_key(2)))
    elif isinstance(j, JA2C):
        j.train_on_rollout(rollout(8, shape, image, 1))
        j.train_on_rollout(rollout(8, shape, image, 2))
    else:
        data = {k: jnp.asarray(v) for k, v in rollout(8, shape, image, 1).items()}
        for i in range(2):
            j.params, j.opt_state, _ = j._update(j.params, j.opt_state, data,
                                                 jnp.arange(4) + 4 * i, jax.random.PRNGKey(i))


def _find(tree, key):
    """The first value under ``key`` in a nested dict, depth first."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for value in tree.values():
            found = _find(value, key)
            if found is not None:
                return found
    return None


def check_state(t, tree) -> None:
    """The port's algorithm holds exactly the state of JAX's tree."""
    stacked = isinstance(t, MultiSeedPPO)
    convert = from_flax_stacked if stacked else from_flax
    sd = state_dict(tree)
    params = t.params if stacked else dict(t.policy.named_parameters())
    want = convert(sd["policy_params"])
    assert set(want) == set(params)
    for k, v in want.items():
        assert torch.equal(params[k].detach(), v), k
    opt = sd["opt_state"]
    for got, key in ((t.optimizer.mu, "mu"), (t.optimizer.nu, "nu")):
        if _find(opt, key) is None:
            assert got == [] and t.optimizer.kind == "rmsprop"
            continue
        moment = convert(_find(opt, key))
        assert set(moment) == set(t.param_names)
        for name, value in zip(t.param_names, got):
            assert torch.equal(value, moment[name]), name
    if t.optimizer.kind == "adam":
        assert np.array_equal(np.asarray(t.optimizer.count), _find(opt, "count"))
    assert t.num_timesteps == int(sd["num_timesteps"])


@pytest.mark.parametrize("kind", KINDS)
def test_agent_files_both_ways(kind, tmp_path):
    """A file JAX wrote after its own updates resumes the port bitwise, and
    the port writes it back unchanged; after the port's own updates, the
    file it writes restores in JAX through flax's strict ``from_bytes`` and
    holds the port's state bitwise."""
    j, t, shape, image = make_pair(kind)
    with jax.default_matmul_precision("highest"):
        jax_updates(j, shape, image)
    j.num_timesteps = 77
    jsave_checkpoint(tmp_path / "jax.ckpt", j.save(), {"num_timesteps": 77})
    assert load_algo(tmp_path / "jax.ckpt", t) == {"num_timesteps": 77}
    check_state(t, j.save())
    assert t.optimizer.kind == "rmsprop" or np.asarray(t.optimizer.count).max() == 2
    assert same(agent_tree(t), load_checkpoint(tmp_path / "jax.ckpt")[0])

    port_updates(t, shape, image)
    t.num_timesteps = 123
    save_algo(tmp_path / "port.ckpt", t, {"num_timesteps": 123})
    payload = (tmp_path / "port.ckpt").read_bytes()
    meta_len = int.from_bytes(payload[8:16], "little")
    restored = serialization.from_bytes(j.save(), payload[16 + meta_len:])   # strict
    check_state(t, restored)
    assert t.optimizer.kind == "rmsprop" or np.asarray(t.optimizer.count).max() == 4
    tree, meta = jload_checkpoint(tmp_path / "port.ckpt", j.save())
    assert meta == {"num_timesteps": 123}
    j.load(tree)
    assert j.num_timesteps == 123


def test_a_seeds_mismatch_raises_and_params_only_files_load_partially(tmp_path):
    j, t, shape, image = make_pair("multi")
    jsave_checkpoint(tmp_path / "agent.ckpt", j.save(), {})
    other = MultiSeedPPO([build_policy(gt_port_config(), seed=s, device="cpu") for s in (5, 6)],
                         shape, image, 2, tcfg.PPOConfig(batch_size=4), [5, 6], device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        load_algo(tmp_path / "agent.ckpt", other)
    with pytest.raises(ValueError, match="seeds"):
        JMultiSeedPPO(j.policy, shape, image, 2, JPPOConfig(), [5, 6]).load(
            jload_checkpoint(tmp_path / "agent.ckpt", j.save())[0])
    with jax.default_matmul_precision("highest"):
        jax_updates(j, shape, image)
    tree = state_dict(j.save())
    params_only = {"policy_params": tree["policy_params"], "seeds": tree["seeds"],
                   "num_timesteps": 9}
    jsave_checkpoint(tmp_path / "params.ckpt", params_only, {})
    with pytest.raises(ValueError, match="lacks"):
        load_algo(tmp_path / "params.ckpt", t)
    fresh = [m.clone() for m in t.optimizer.nu]
    load_algo(tmp_path / "params.ckpt", t, allow_partial=True)
    for k, v in from_flax_stacked(tree["policy_params"]).items():
        assert torch.equal(t.params[k], v)
    assert all(torch.equal(a, b) for a, b in zip(t.optimizer.nu, fresh))
    assert t.num_timesteps == 9 and int(t.optimizer.count.max()) == 0


def _decoded(data: bytes):
    from PIL import Image
    import imageio.v2 as imageio

    im = Image.open(io.BytesIO(data))
    pil = []
    for i in range(im.n_frames):
        im.seek(i)
        pil.append(np.asarray(im.convert("RGB")))
    iio = [np.asarray(f)[..., :3] for f in imageio.mimread(io.BytesIO(data), format="GIF")]
    return np.stack(pil), np.stack(iio)


@pytest.mark.parametrize("colours", [1, 5, 256, 4096])
def test_gif_decodes_in_pil_and_imageio(colours):
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    frames = palette[rng.integers(0, colours, (3, 24, 40))]
    data = gif.encode(frames)
    pil, iio = _decoded(data)
    assert np.array_equal(pil, iio)
    distinct = np.unique(frames.reshape(-1, 3), axis=0)
    if len(distinct) <= 256:
        assert np.array_equal(pil, frames)
        return
    # the stated rule, computed here on its own: the 256 most frequent
    # colours (ties to the smaller packed RGB), each pixel to the nearest
    flat = frames.reshape(-1, 3).astype(np.int64)
    packed = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    values, counts = np.unique(packed, return_counts=True)
    top = sorted(zip(-counts, values))[:256]
    pal = np.array([[(v >> 16) & 255, (v >> 8) & 255, v & 255] for _, v in top])
    nearest = ((flat[:, None, :] - pal[None]) ** 2).sum(-1).argmin(1)
    assert np.array_equal(pil.reshape(-1, 3), pal[nearest])
    kept = np.isin(packed, [v for _, v in top])
    assert np.array_equal(pil.reshape(-1, 3)[kept], flat[kept])


def test_gif_of_env_frames_is_lossless():
    from ocrl_tpu_torch.envs import make_env

    env = make_env(tcfg.read_env_config("target-N4C4S3S1"), 0)
    env.reset()
    frames = []
    for i in range(30):
        env.step(i % 4)
        frames.append(env.render("rgb_array"))
    frames = np.stack(frames)
    pil, iio = _decoded(gif.encode(frames))
    assert np.array_equal(pil, frames) and np.array_equal(iio, frames)


def test_video_recorder_names_match_jax(tmp_path):
    from ocrl_tpu.rl.video import VideoRecorder as JVideoRecorder

    class Frames:
        def __init__(self):
            self.i = 0

        def render_frame(self):
            self.i += 1
            return np.full((8, 8, 3), self.i % 7 * 30, np.uint8)

    recorders = (JVideoRecorder(tmp_path / "jax", 500, 4), VideoRecorder(tmp_path / "port", 500, 4))
    steps = 0
    for _ in range(60):
        steps += 48
        for rec in recorders:
            rec.maybe_record(Frames(), steps)
    steps += 48
    for rec in recorders:
        rec.maybe_record(Frames(), steps)
        rec.close()
    names = [sorted(p.name for p in (tmp_path / d).glob("*.gif")) for d in ("jax", "port")]
    assert names[0] == names[1] and len(names[0]) >= 4
    assert sorted(p.name for p in recorders[1].written) == names[1]


CYCLE = ["ocr=gt", "pooling=mlp", "sb3=ppo", "sb3_acnet=mlp", "env=target-N4C4S3S1",
         "seeds=11,22", "num_envs=2", "sb3.algo_kwargs.n_steps=8",
         "sb3.algo_kwargs.batch_size=4", "sb3.algo_kwargs.n_epochs=2", "vec_env=dummy",
         "eval.freq=4", "eval.n_episodes=2", "video.interval=16", "video.length=3"]
JAX_METRICS = ("policy_loss", "value_loss", "entropy", "approx_kl", "loss")


def test_train_resume_test_cycle_through_the_entry_points(tmp_path):
    """tests/test_cli_e2e.py:57's cycle, here through the port's mains."""
    run = tmp_path / "run"
    first = train_sb3.main(CYCLE + ["max_steps=24", f"run_dir={run}"], device="cpu")
    assert first["algo"].num_timesteps == 48 and first["algo"].seeds == [11, 22]
    latest = run / "models" / "latest_model.ckpt"
    assert latest.exists() and (run / "models" / "best_model.ckpt").exists()
    saved = load_checkpoint(latest)[0]
    assert saved["num_timesteps"] == 48 and saved["seeds"] == {"0": 11, "1": 22}
    second = train_sb3.main(CYCLE + ["max_steps=48", f"run_dir={run}", f"resume={latest}"],
                            device="cpu")
    assert second["algo"].num_timesteps == 96
    gifs = sorted(p.name for p in (run / "videos").glob("*.gif"))
    assert gifs and all(_decoded((run / "videos" / g).read_bytes())[0].shape == (3, 64, 64, 3)
                        for g in gifs)
    names = set()
    for line in (run / "metrics.jsonl").read_text().splitlines():
        names |= set(json.loads(line))
    want = {f"train/{k}" for k in JAX_METRICS} | {
        f"train/seed{s}/{k}" for s in (11, 22) for k in JAX_METRICS} | {
        f"eval/{k}" for k in ("success_rate", "mean_reward", "mean_ep_length")} | {
        f"eval/seed{s}/{k}" for s in (11, 22)
        for k in ("success_rate", "mean_reward", "mean_ep_length")}
    assert want <= names
    assert {n for n in names if n.startswith("rollout/")} <= {
        "rollout/success_rate", "rollout/seed11/success_rate", "rollout/seed22/success_rate"}
    result = test_sb3.main(["ocr=gt", "pooling=mlp", "sb3=ppo", "sb3_acnet=mlp",
                            "env=target-N4C4S3S1", "seeds=11,22", "n_eval_episodes=2",
                            f"agent_checkpoint.file={run}/models/latest_model"], device="cpu")
    assert sorted(result["per_seed"]) == ["seed11", "seed22"]
    assert set(result["summary"]) == {"success_rate", "mean_reward", "mean_ep_length"}
    assert result["num_timesteps"] == 96
    # JAX's test_sb3 reads the port's file
    jpolicy, _, _, _ = jbuild_policy(jcompose("train_sb3", CYCLE[:5]), seed=0)
    j = JMultiSeedPPO(jpolicy, (5, 5), False, 2, JPPOConfig(), [11, 22])
    tree, meta = jload_checkpoint(latest, j.save(), allow_partial=True)
    j.load(tree)
    assert j.num_timesteps == 96 and meta["num_timesteps"] == 96


def test_compose_takes_the_run_file_options():
    cfg = tcfg.compose(tcfg.TrainSB3Config(), [
        "ocr=gt", "seeds=1234,2345,3456", "resume=r/models/latest_model.ckpt",
        "video.interval=10", "video.length=3", "+pipeline_rollout=True",
        "cache_frozen_reps=True"])
    assert tcfg.seed_list(cfg.seeds) == [1234, 2345, 3456]
    assert (cfg.resume, cfg.video.interval, cfg.video.length) == \
        ("r/models/latest_model.ckpt", 10, 3)
    assert cfg.pipeline_rollout and cfg.cache_frozen_reps
    assert tcfg.seed_list(tcfg.compose(tcfg.TrainSB3Config(), ["seeds=7"]).seeds) == [7]
    assert tcfg.seed_list(tcfg.TrainSB3Config().seeds) is None
    assert tcfg.seed_list(tcfg.compose(tcfg.TestSB3Config(), ["seeds=1,2"]).seeds) == [1, 2]
    assert tcfg.compose(tcfg.TrainSB3Config(), ["sb3=sac"]).sb3 == \
        tcfg.SB3Config("SAC", tcfg.SACConfig())
    for algo in ("a2c", "sac"):                  # seeds= is PPO-only, as JAX's
        with pytest.raises(ValueError, match="PPO-only"):
            train_sb3.main(["ocr=gt", f"sb3={algo}", "env=target-N4C4S3S1", "seeds=1,2"],
                           device="cpu")
