"""Train an OCR with the port (counterpart of the training loop of the
repo-root train_ocr.py, without its data loader, evaluation, checkpoints
and CLI, which come with a later slice).

    from ocrl_tpu_torch.train_ocr import train
    metrics = train(OCRConfig(), EnvConfig(), batches, steps=100, k=4, seed=0)

``batches`` is a sequence of uint8 observation batches [B, H, W, C], used
in turn and cycled; k of them at a time go to ``OCR.update_many``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .config import EnvConfig, OCRConfig
from .models import create_ocr


def train(ocr_config: OCRConfig, env_config: EnvConfig, batches, steps: int,
          k: int = 1, seed: int = 0,
          device: str | torch.device | None = None) -> list[dict]:
    """Build the OCR from the configs and ``seed``, take ``steps`` optimizer
    steps (a multiple of ``k``) and return one dict of float metrics per
    step."""
    if steps % k:
        raise ValueError(f"steps={steps} is not a multiple of k={k}")
    ocr = create_ocr(ocr_config, env_config, seed, device)
    source = itertools.cycle(batches)
    metrics = []
    for step in range(0, steps, k):
        superbatch = np.concatenate([next(source) for _ in range(k)])
        stacked = ocr.update_many(superbatch, None, step, k)
        host = {key: value.tolist() for key, value in stacked.items()}
        metrics += [{key: host[key][i] for key in host} for i in range(k)]
    return metrics
