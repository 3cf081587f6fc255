"""``train_sb3.main`` on each of the seven for_running.json rows of the
other OCRs, with the row's own overrides (the VAE and IODINE rows'
checkpoint being the committed artifacts/encoders file, the MAE rows' none,
so they run end to end) at full width, for one tiny PPO iteration; A2C on
the VAE row. (A file of their own beside tests/test_torch_rl_ocrs.py, so
that a test run that keeps each file on one worker can spread them.)
"""

import json
from pathlib import Path

import numpy as np
import pytest

from ocrl_tpu_torch import train_sb3
from ocrl_tpu_torch.rl import A2C, PPO

ROOT = Path(__file__).resolve().parents[1]
ROWS = ["e2e cnn 0.01ent_coef", "e2e cnnfeat-transformer 0.01ent_coef",
        "multiple cnn-transformer 0.01ent_coef", "vae-mlp-0.01ent_coef",
        "mae-patch-transformer-0.01ent_coef", "mae-cls-mlp-0.01ent_coef",
        "iodine-transformer-0.01ent_coef"]
TINY = ["sb3.algo_kwargs.n_steps=8", "sb3.algo_kwargs.batch_size=4",
        "sb3.algo_kwargs.n_epochs=1", "num_envs=2", "max_steps=8", "vec_env=dummy",
        "eval.freq=1000"]


def row_argv(name):
    """A for_running.json row's overrides on target-N4C4S3S1, its OCR
    checkpoint the committed artifacts/encoders file where there is one;
    MAE has none in the repo, so its rows run end to end."""
    row = dict(json.loads((ROOT / "for_running.json").read_text())["ocrs"][name])
    row.pop("tags")
    checkpoint = Path(row.pop("pooling.ocr_checkpoint.local_file", ""))
    argv = [f"{k}={v}" for k, v in row.items()] + ["env=target-N4C4S3S1"]
    committed = ROOT / "artifacts" / "encoders" / checkpoint.name
    if checkpoint.name and committed.exists():
        argv.append(f"pooling.ocr_checkpoint.local_file={committed}")
    return argv


@pytest.mark.parametrize("name", ROWS)
def test_each_row_trains_through_main(name, tmp_path):
    result = train_sb3.main(row_argv(name) + TINY + [f"run_dir={tmp_path}"], device="cpu")
    algo = result["algo"]
    assert isinstance(algo, PPO) and algo.num_timesteps == 8
    assert algo.last_iteration["updates"] == 2
    assert all(np.isfinite(v) for v in result["metrics"].values())
    assert algo.policy.freeze_ocr == name.startswith(("vae", "iodine"))
    assert (tmp_path / "metrics.jsonl").exists()


def test_a2c_on_the_vae_row(tmp_path):
    argv = [a for a in row_argv("vae-mlp-0.01ent_coef") if a != "sb3=ppo"] + [
        "sb3=a2c", "num_envs=2", "max_steps=20", "vec_env=dummy", "eval.freq=1000",
        f"run_dir={tmp_path}"]
    result = train_sb3.main(argv, device="cpu")
    algo = result["algo"]
    assert isinstance(algo, A2C) and algo.num_timesteps == 20 and algo.optimizer.count == 5
    assert algo.policy.freeze_ocr and all(np.isfinite(v) for v in result["metrics"].values())
