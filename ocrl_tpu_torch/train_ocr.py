"""Train an OCR with the port (counterpart of the training loop of the
repo-root train_ocr.py, without its data loader, evaluation, checkpoints
and CLI):

    from ocrl_tpu_torch.train_ocr import train
    metrics = train(OCRConfig(), EnvConfig(), batches, steps=100, k=4, seed=0)

``batches`` is a sequence of uint8 observation batches [B, H, W, C], or of
dicts {"obss", "masks"} whose masks [B, K, H, W, 1] go to the steps too
(an ``ari`` metric), used in turn and cycled; k of them at a time go to
``OCR.update_many``. Every OCR with a loss trains: SLATE and
Slot-Attention, VAE, MAE and IODINE (NatureCNN's and MultipleCNN's steps
leave them as they are).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .config import EnvConfig, OCRConfigs
from .models import create_ocr


def pretraining_config(ocr_config: OCRConfigs, batch_size: int) -> OCRConfigs:
    """The OCR config as the entry point trains it: MAE's learning rate
    scaled by batch_size / 256 (train_ocr.py:34-36), the others as they are."""
    if ocr_config.name != "MAE":
        return ocr_config
    learning = dataclasses.replace(ocr_config.learning,
                                   lr=ocr_config.learning.lr * batch_size / 256)
    return dataclasses.replace(ocr_config, learning=learning)


def train(ocr_config: OCRConfigs, env_config: EnvConfig, batches, steps: int,
          k: int = 1, seed: int = 0,
          device: str | torch.device | None = None) -> list[dict]:
    """Build the OCR from the configs (``pretraining_config`` at the first
    batch's size) and ``seed``, take ``steps`` optimizer steps (a multiple
    of ``k``) and return one dict of float metrics per step."""
    if steps % k:
        raise ValueError(f"steps={steps} is not a multiple of k={k}")
    source = itertools.cycle({"obss": b} if not isinstance(b, dict) else b for b in batches)
    first = next(source)
    source = itertools.chain([first], source)
    ocr = create_ocr(pretraining_config(ocr_config, len(first["obss"])), env_config, seed,
                     device)
    metrics = []
    for step in range(0, steps, k):
        group = [next(source) for _ in range(k)]
        masks = np.concatenate([b["masks"] for b in group]) if "masks" in first else None
        stacked = ocr.update_many(np.concatenate([b["obss"] for b in group]), masks, step, k)
        host = {key: value.tolist() for key, value in stacked.items()}
        metrics += [{key: host[key][i] for key in host} for i in range(k)]
    return metrics
