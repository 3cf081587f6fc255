"""The run's metric log (counterpart of ocrl_tpu/utils/logger.py, without
wandb or YAML): ``Run`` makes the run directory, writes the config as
``config.json`` and the run's name and tags as ``run.json``, and appends
each ``log`` call to ``metrics.jsonl`` as one JSON line with ``_step`` and
``_time``. A value that is a list of ``Image`` is written as PNGs under
``media/`` (``utils.png``, no PIL) and logged as its path
relative to the run directory, as JAX's ``_save_image`` does."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from . import png


class Image:
    """An array to log as an image (like wandb.Image): uint8 as it is,
    floats clipped to [0, 1] and scaled by 255."""

    def __init__(self, data):
        self.data = np.asarray(data)


def _plain(value):
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    return _scalar(value)


def _scalar(value):
    if hasattr(value, "item") and getattr(value, "ndim", 1) == 0:
        return value.item()
    if isinstance(value, np.ndarray) or hasattr(value, "tolist"):
        arr = np.asarray(value)
        return arr.reshape(()).item() if arr.size == 1 else arr.tolist()
    return value


class Run:
    def __init__(self, run_dir: str | Path, name: str, config=None, tags=()):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.metrics_file = self.dir / "metrics.jsonl"
        if config is not None:
            (self.dir / "config.json").write_text(json.dumps(_plain(config), indent=1))
        (self.dir / "run.json").write_text(json.dumps(
            {"name": name, "tags": [t for t in tags if t], "t0": time.time()}))
        self._step = 0

    def log(self, metrics: dict, step: int | None = None) -> None:
        """One JSON line: ``_step`` (the next one when None), ``_time``, and
        the metrics as plain numbers or lists."""
        if step is None:
            step = self._step
        self._step = max(self._step, step) + 1
        record = {"_step": int(step), "_time": time.time()}
        for key, value in metrics.items():
            if isinstance(value, (list, tuple)) and value and isinstance(value[0], Image):
                record[key] = [self._save_image(f"{key}_{i}", v.data, step)
                               for i, v in enumerate(value)]
            else:
                record[key] = _scalar(value)
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(record) + "\n")


    def _save_image(self, key: str, arr: np.ndarray, step: int) -> str:
        """``media/<key>_step<step>.png`` (``/`` in the key as ``_``); its
        path relative to the run directory."""
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        path = self.dir / "media" / f"{key.replace('/', '_')}_step{step}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        png.write(path, arr)
        return str(path.relative_to(self.dir))


def log_prefix(config) -> str:
    """The run-name prefix of ocrl_tpu/utils/__init__.py:11-29 for the OCRs
    and the pooling of the port."""
    ocr = config.ocr
    if ocr.name == "VAE":
        prefix = f"{ocr.name}N{ocr.cnn_feat_size ** 2}" if ocr.use_cnn_feat else ocr.name
    elif ocr.name in ("SlotAttn", "SLATE"):
        prefix = f"{ocr.name}N{ocr.slotattr.num_slots}"
    else:
        prefix = ocr.name
    pooling = getattr(config, "pooling", None)
    if pooling is not None:
        cpt = pooling.ocr_checkpoint
        if cpt.run_id or cpt.local_file:
            prefix = "Pretrained-" + prefix
        if pooling.learn_aux_loss:
            prefix += "Aux"
        if pooling.learn_downstream_loss:
            prefix += "FineTune"
        prefix += f"-{pooling.name}"
    return prefix
