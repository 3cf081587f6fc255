"""The port as a package: what it imports, where it runs, its config."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ocrl_tpu.config import compose
from ocrl_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yaml", "h5py", "msgpack", "ocrl_tpu",
             "gymnasium", "PIL", "matplotlib", "imageio", "wandb",
             "torch.utils.cpp_extension")


def _port_files():
    return sorted((ROOT / "ocrl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_nothing_forbidden():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        for name in _imported(ast.parse(path.read_text(), str(path))):
            if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {FORBIDDEN[:-1]!r}: sys.modules[name] = None\n"
        "import ocrl_tpu_torch\n"
        "for m in pkgutil.walk_packages(ocrl_tpu_torch.__path__, 'ocrl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr


def test_entry_points_need_a_card_or_an_explicit_cpu():
    from ocrl_tpu_torch.rl import PPO, build_policy

    cfg = tcfg.PolicyConfig()
    if torch.cuda.is_available():
        policy = build_policy(cfg, seed=0)
        assert next(policy.parameters()).is_cuda
        assert PPO(policy, (64, 64, 3)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_policy(cfg, seed=0)
    policy = build_policy(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPO(policy, (64, 64, 3))


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("ocr", ["slate", "slotattention"])
def test_config_matches_the_yaml(ocr):
    """The port's dataclasses hold what compose() gives, except
    slotattr.fused: auto in the port (the YAML's `never` was decided by a
    TPU measurement), and ``amp``, the field of the ``ocr.amp`` override,
    which no YAML sets: None on both sides (JAX reads ``ocr.get("amp")``)."""
    cfg = compose("train_sb3", [f"ocr={ocr}", "pooling=transformer", "sb3=ppo",
                                "sb3_acnet=mlp", "env=target-N4C4S3S1"])
    port = tcfg.PolicyConfig()
    if ocr == "slotattention":
        port = tcfg.replace(port, "ocr.use_bcdec", True)
    want_ocr = _plain(cfg.ocr.to_dict())
    assert want_ocr["slotattr"]["fused"] == "never"
    want_ocr["slotattr"]["fused"] = "auto"
    port_ocr = _plain(dataclasses.asdict(port.ocr))
    assert port_ocr.pop("amp") is None and cfg.ocr.get("amp") is None
    assert port_ocr == want_ocr
    assert _plain(dataclasses.asdict(port.pooling)) == _plain(cfg.pooling.to_dict())
    assert _plain(dataclasses.asdict(port.sb3_acnet)) == _plain(cfg.sb3_acnet.to_dict())
    for key, value in dataclasses.asdict(port.env).items():
        assert cfg.env[key] == value, key


@pytest.mark.parametrize("algo", ["ppo", "a2c", "sac"])
def test_sb3_configs_match_the_yaml(algo):
    """The port's SB3Config holds configs/sb3/<algo>.yaml (the JAX
    from_algo_kwargs drops the YAML's nulls for the dataclass defaults)."""
    from ocrl_tpu.rl import A2CConfig, PPOConfig, SACConfig

    cfg = compose("train_sb3", ["ocr=gt", "pooling=transformer", f"sb3={algo}",
                                "sb3_acnet=mlp", "env=target-N4C4S3S1"])
    port = tcfg.GROUPS["sb3"][algo]
    assert port.name == cfg.sb3.name
    jax_cls = {"ppo": PPOConfig, "a2c": A2CConfig, "sac": SACConfig}[algo]
    want = dataclasses.asdict(jax_cls.from_algo_kwargs(cfg.sb3.algo_kwargs.to_dict()))
    assert dataclasses.asdict(port.algo_kwargs) == want
    for key, value in cfg.sb3.algo_kwargs.to_dict().items():
        assert getattr(port.algo_kwargs, key) == value, key


@pytest.mark.parametrize("entry", ["train_sb3", "test_sb3"])
def test_entry_configs_match_the_yaml(entry):
    cfg = compose(entry, ["ocr=gt", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
                          "env=target-N4C4S3S1"])
    port = tcfg.compose(tcfg.TrainSB3Config() if entry == "train_sb3" else tcfg.TestSB3Config(),
                        ["ocr=gt", "env=target-N4C4S3S1"])
    assert _plain(dataclasses.asdict(port.ocr)) == _plain(cfg.ocr.to_dict())
    assert port.seed == cfg.seed and port.tags == cfg.tags
    if entry == "train_sb3":
        assert (port.num_envs, port.max_steps) == (cfg.num_envs, cfg.max_steps)
        assert _plain(dataclasses.asdict(port.eval)) == _plain(cfg.eval.to_dict())
    else:
        assert port.n_eval_episodes == cfg.n_eval_episodes
        for key, value in cfg.agent_checkpoint.to_dict().items():
            assert getattr(port.agent_checkpoint, key) == value, key
    assert dataclasses.asdict(port.env) == dataclasses.asdict(
        tcfg.read_env_config("target-N4C4S3S1"))
