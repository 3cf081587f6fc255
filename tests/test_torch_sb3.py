"""The port's two RL entry points and the committed agents.

- ``train_sb3.train``: one tiny PPO iteration (n_steps 64, batch 16, 2
  epochs) at small SLATE widths, and A2C on GT; metrics come back and land
  in the run's metrics.jsonl;
- ``test_sb3.main`` on a committed GT agent file, 4 episodes;
- ``config.compose``: the overrides, those of the run files (seeds, video,
  resume), and the later slices that raise;
- every committed ``artifacts/rl/*-final.ckpt``, each of its three seeds
  (the port's seed slicing, ``test_sb3.agent_params``): the port's logits
  and values on env states against the JAX ``ActorCriticPolicy.apply``, in
  fp32 within 1e-5 of the outputs' scale (the largest |logit|, at least 1),
  and in float64 within 1e-10 (the same function; in fp32 each side lies up
  to 3.7e-5 from the float64 value on some of these agents).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.config import compose as jcompose
from ocrl_tpu.rl import build_policy as jbuild_policy

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import test_sb3, train_sb3
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.rl import A2C, PPO, build_policy
from ocrl_tpu_torch.test_sb3 import agent_params
from ocrl_tpu_torch.utils.checkpoint import load_checkpoint
from ocrl_tpu_torch.utils.convert import from_flax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
GT_JAX = ["ocr=gt", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp"]
SMALL = ["env.obs_size=16", "ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=3",
         "ocr.slotattr.slot_size=32", "ocr.slotattr.mlp_hidden_size=32",
         "pooling.d_model=32", "pooling.nhead=4"]
ODD = ROOT / "artifacts" / "rl" / "GT-Transformer-PPO-OddOneOutN4C2S2S1Env-final"


def test_train_one_tiny_ppo_iteration(tmp_path):
    argv = ["ocr=slate", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
            "env=target-N4C4S3S1", *SMALL, "sb3.algo_kwargs.n_steps=64",
            "sb3.algo_kwargs.batch_size=16", "sb3.algo_kwargs.n_epochs=2",
            "sb3.algo_kwargs.ent_coef=0.01", "max_steps=64", "num_envs=2",
            "vec_env=dummy", "eval.freq=32", "eval.n_episodes=2", f"run_dir={tmp_path}"]
    result = train_sb3.main(argv, device="cpu")
    algo = result["algo"]
    assert isinstance(algo, PPO) and algo.num_timesteps == 64
    assert algo.last_iteration["updates"] == 2 * 64 // 16
    assert algo.last_iteration["policy_calls"] == 32 + 1
    assert set(result["metrics"]) == {"policy_loss", "value_loss", "entropy", "approx_kl",
                                      "loss"}
    assert all(np.isfinite(v) for v in result["metrics"].values())
    assert 0.0 <= result["eval"]["success_rate"] <= 1.0
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("train/loss" in r for r in records) and any("eval/success_rate" in r
                                                          for r in records)
    assert json.loads((tmp_path / "config.json").read_text())["sb3"]["algo_kwargs"][
        "ent_coef"] == 0.01


def test_train_a2c_on_gt(tmp_path):
    argv = GT_JAX[:2] + ["sb3=a2c", "sb3_acnet=mlp", "env=push-N3C4S1S1", "max_steps=20",
                         "num_envs=4", "vec_env=subproc", "eval.freq=1000",
                         f"run_dir={tmp_path}"]
    result = train_sb3.main(argv, device="cpu")
    assert isinstance(result["algo"], A2C) and result["algo"].num_timesteps == 20
    assert result["algo"].is_image_obs is False and result["eval"] is None
    assert result["algo"].optimizer.count == 5


def test_test_sb3_on_a_committed_agent():
    metrics = test_sb3.main(GT_JAX[:2] + ["sb3=ppo", "sb3_acnet=mlp", "pooling.num_layers=3",
                                          "env=odd-one-out-N4C2S2S1", f"agent_checkpoint.file={ODD}",
                                          "agent_checkpoint.seed=2345", "n_eval_episodes=4"],
                            device="cpu")
    assert metrics["seed"] == 2345 and metrics["num_timesteps"] > 0
    assert 0.0 <= metrics["success_rate"] <= 1.0 and metrics["mean_ep_length"] > 0


def test_compose_overrides():
    cfg = tcfg.compose(tcfg.TrainSB3Config(), [
        "sb3.algo_kwargs.ent_coef=0.01", "ocr=gt", "sb3=a2c", "env=maze-N4C4S4S2",
        "seed=3", "+num_envs=8", "max_steps=1e4", "eval.freq=50", "env.max_steps=50",
        "sb3.algo_kwargs.learning_rate=1e-3"])
    assert cfg.ocr == tcfg.GTConfig() and cfg.sb3.name == "A2C"
    assert cfg.sb3.algo_kwargs == tcfg.A2CConfig(learning_rate=1e-3, ent_coef=0.01)
    assert (cfg.seed, cfg.num_envs, cfg.max_steps, cfg.eval.freq) == (3, 8, 1e4, 50)
    assert cfg.env.name == "MazeN4C4S4S2Env" and cfg.env.max_steps == 50
    with pytest.raises(KeyError):            # a field A2C does not have
        tcfg.compose(tcfg.TrainSB3Config(), ["sb3=a2c", "sb3.algo_kwargs.batch_size=4"])
    cfg = tcfg.compose(tcfg.TrainSB3Config(), ["sb3=sac", "env=cw-target-N4C4S1S1"])
    assert cfg.sb3 == tcfg.SB3Config("SAC", tcfg.SACConfig())
    assert cfg.env == tcfg.read_env_config("cw-target-N4C4S1S1") and \
        isinstance(cfg.env, tcfg.CwEnvConfig)
    cfg = tcfg.compose(tcfg.TrainSB3Config(), ["ocr=vae", "seeds=1,2,3", "video.interval=5",
                                               "resume=models/latest_model.ckpt"])
    assert (tcfg.seed_list(cfg.seeds), cfg.video.interval, cfg.resume) == \
        ([1, 2, 3], 5, "models/latest_model.ckpt")
    with pytest.raises(FileNotFoundError, match="available: .*iodine_large"):
        tcfg.compose(tcfg.TrainSB3Config(), ["ocr=iodine"])


def test_entry_points_need_a_card_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_sb3.main(GT_JAX[:2] + ["sb3=ppo", "sb3_acnet=mlp", "pooling.num_layers=3",
                                    "env=odd-one-out-N4C2S2S1", f"agent_checkpoint.file={ODD}",
                                    "n_eval_episodes=1"])


def gt_port_config(env, **pooling):
    cfg = tcfg.PolicyConfig(ocr=tcfg.GTConfig(), env=tcfg.read_env_config(env))
    for key, value in pooling.items():
        cfg = tcfg.replace(cfg, f"pooling.{key}", value)
    return cfg


AGENTS = sorted((ROOT / "artifacts" / "rl").glob("*-final.ckpt"))
AGENT_ENVS = {"OddOneOutN4C2S2S1Env": "odd-one-out-N4C2S2S1",
              "OddOneOutN4C2S2S1EnvOC": "odd-one-out-N4C2S2S1-oc",
              "PushN3C4S1S1Env": "push-N3C4S1S1"}


def _agent_env(path: Path) -> str:
    return AGENT_ENVS[path.name.split("-")[3]]


def test_every_committed_agent_is_covered():
    assert len(AGENTS) == 3 and {_agent_env(p) for p in AGENTS} == set(AGENT_ENVS.values())


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("path", AGENTS, ids=[p.name for p in AGENTS])
def test_committed_agents_match_jax(path, index):
    """GT + Transformer pooling (3 post-LN layers over 5-wide states), one
    seed's slice: logits and values on 64 env states."""
    env_name = _agent_env(path)
    cpt = tcfg.AgentCheckpointConfig(file=str(path), index=index)
    params, meta = agent_params(cpt)
    tree, _ = load_checkpoint(path)
    assert meta["seed"] == int(tree["seeds"][str(index)])
    cfg = gt_port_config(env_name, num_layers=3)
    env_cfg = tcfg.replace(cfg.env, "render_mode", "state")
    env = make_env(env_cfg, 100 + index)
    states, obs = [], env.reset()
    rng = np.random.default_rng(index)
    while len(states) < 64:
        states.append(obs)
        obs, _, done, _ = env.step(int(rng.integers(4)))
        if done:
            obs = env.reset()
    states = np.stack(states).astype(np.float32)

    jcfg = jcompose("train_sb3", GT_JAX + [f"env={env_name}", "pooling.num_layers=3"])
    jpolicy, _, _, _ = jbuild_policy(jcfg, seed=0)
    apply = jax.jit(jpolicy.apply)
    with jax.default_matmul_precision("highest"):
        want = apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(states))
    policy = build_policy(cfg, seed=0, device="cpu")
    policy.load_state_dict(from_flax(params))
    algo = PPO(policy, states.shape[1:], is_image_obs=False, device="cpu")
    _, logits, values = algo.act_deterministic(states)
    for g, w in zip((logits, values), want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL * max(1.0, np.abs(w).max())
    # the same function to float64 rounding: in fp32 each side lies up to
    # 3.7e-5 from the float64 value on some of these agents
    with jax.enable_x64(True):
        want64 = [np.asarray(x) for x in apply(
            {"params": jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)},
            jnp.asarray(states, jnp.float64))]
    with torch.no_grad():
        got64 = policy.double()(torch.from_numpy(states).double())
    for g, w in zip(got64, want64):
        assert w.dtype == np.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("finetuning", [False, True])
def test_a_configured_ocr_checkpoint_is_loaded_and_frozen(tmp_path, finetuning):
    """The JAX freeze rule: a configured OCR checkpoint loads into the
    policy's OCR, which is frozen unless ``finetuning``."""
    from ocrl_tpu.models import create_ocr as jcreate_ocr
    from ocrl_tpu.utils.checkpoint import save_checkpoint
    from ocrl_tpu_torch.utils.convert import ocr_from_flax

    from test_torch_models import SMALL_JAX, small_port_config

    jcfg = jcompose("train_sb3", SMALL_JAX)
    jocr = jcreate_ocr(jcfg.ocr, jcfg.env, seed=4)
    save_checkpoint(tmp_path / "ocr.ckpt", jocr.save(), {})
    cfg = small_port_config()
    assert build_policy(cfg, seed=0, device="cpu").freeze_ocr is False   # end to end
    cfg = tcfg.replace(cfg, "pooling.ocr_checkpoint.local_file", str(tmp_path / "ocr.ckpt"))
    cfg = tcfg.replace(cfg, "pooling.ocr_checkpoint.finetuning", finetuning)
    policy = build_policy(cfg, seed=0, device="cpu")
    assert policy.freeze_ocr is (not finetuning)
    want = ocr_from_flax(jax.tree.map(np.asarray, jocr.params))
    got = policy.ocr_module.state_dict()
    assert got and set(got) <= set(want)
    for key, value in got.items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)
    algo = PPO(policy, (16, 16, 3), device="cpu")
    assert any(n.startswith("ocr_module.") for n in algo.param_names) is finetuning
