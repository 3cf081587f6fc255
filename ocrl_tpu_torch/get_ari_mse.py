"""Segmentation and reconstruction evaluation with the port (counterpart of
the repo-root get_ari_mse.py, without its HDF5 loader and logger):

    from ocrl_tpu_torch.config import GetAriMseConfig, OCRCheckpointConfig
    from ocrl_tpu_torch.get_ari_mse import main
    cfg = GetAriMseConfig(ocr_checkpoint=OCRCheckpointConfig(local_file="model_best.ckpt"))
    results = main(cfg, {"obss": obss, "masks": masks})   # {"ari": ..., "mse": ...}

``obss`` are uint8 images [N, H, W, C] and ``masks`` uint8 [N, K, H, W, 1]
with the background last, in memory; ``main`` cuts them into batches of
``batch_size`` in order, the last one partial, as the validation loader
does. ``evaluate(ocr, batches, seed)`` takes an OCR and batches directly.

Per batch: the foreground ARI of ``OCR.get_loss(obs, masks)``, which draws
from the OCR's own generator; then for SLATE with the transformer decoder
the autoregressive MSE, sum((obs - gen_imgs(slots)) ** 2) / B, with the
slots of a second slot-attention pass on noise from a generator seeded by
``seed``; for ``use_bcdec`` and for IODINE the loss's ``mse`` instead. The
other OCRs produce no masks and raise ``ValueError``, as JAX's entry does.
The results are the means over the batches. Runs on the card unless the
OCR was built with ``device="cpu"``.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .config import GetAriMseConfig
from .models.base import OCR, normalize_obs
from .models.iodine import Iodine_Module
from .models.slate import SLATE_Module
from .utils.checkpoint import get_ocr

log = logging.getLogger(__name__)
# the OCRs that produce masks, by config name: the only ones scored here
SCORED = {"SLATE": SLATE_Module, "Iodine": Iodine_Module}


def _refuse_unmasked(name: str) -> None:
    raise ValueError(f"get_ari_mse needs a mask-producing OCR (SLATE/Slot-Attention/"
                     f"Iodine), got {name}")


def batches_of(data: dict, batch_size: int):
    """Consecutive batches of every array in ``data``, the last partial."""
    n = len(data["obss"])
    for start in range(0, n, batch_size):
        yield {key: value[start:start + batch_size] for key, value in data.items()}


@torch.no_grad()
def _gen_mse(module: SLATE_Module, obs: torch.Tensor, generator: torch.Generator,
             noise: dict | None) -> torch.Tensor:
    """sum((obs - gen_imgs(slots)) ** 2) / B (get_ari_mse.py:47-51); the slot
    noise ``gen_slots`` of ``noise`` is used, or drawn and stored into it."""
    shape = (obs.shape[0], module.slotattn.num_slots, module.slotattn.slot_size)
    if noise is not None and "gen_slots" in noise:
        slot_noise = noise["gen_slots"]
    else:
        slot_noise = torch.randn(shape, generator=generator, device=obs.device)
        if noise is not None:
            noise["gen_slots"] = slot_noise
    slots, _ = module.get_slots(obs, slot_noise)
    return ((obs - module.gen_imgs(slots)) ** 2).sum() / obs.shape[0]


def evaluate(ocr: OCR, batches, seed: int = 0, *, with_gen_mse: bool = True,
             noise: list[dict] | None = None) -> dict:
    """{"ari", "mse"}: the means over ``batches`` ({"obss", "masks"} each)
    of the foreground ARI and of the MSE (see the module docstring), and
    "batches", a dict per batch with its ``ari``, ``mse`` and the host
    seconds of its loss part (``loss_s``) and of its generation part
    (``gen_s``), each ending where its number reached the host.

    ``noise``, one dict per batch, holds the draws to use or receives those
    made: the loss's ``soft``, ``ids`` and ``slots`` (see ``SLATE_Module``)
    and the generation's slot noise ``gen_slots``; IODINE's ``eps``."""
    module = ocr.module
    if not isinstance(module, tuple(SCORED.values())):
        _refuse_unmasked(type(module).__name__)
    generator = torch.Generator(device=ocr.device).manual_seed(seed)
    gen_mse = with_gen_mse and isinstance(module, SLATE_Module) and not module.use_bcdec
    per_batch = []
    for i, batch in enumerate(batches):
        if "masks" not in batch:
            raise KeyError("a batch has no 'masks'; collect the dataset with "
                           "collection.with_masks=True")
        drawn = None if noise is None else noise[i]
        t0 = time.perf_counter()
        metrics = ocr.get_loss(batch["obss"], batch["masks"], noise=drawn)
        ari = float(metrics["ari"])
        t1 = time.perf_counter()
        if gen_mse:
            obs = normalize_obs(torch.as_tensor(np.asarray(batch["obss"])).to(ocr.device))
            mse = float(_gen_mse(module, obs, generator, drawn))
        else:
            mse = float(metrics["mse"] if "mse" in metrics else metrics["dvae_mse"])
        t2 = time.perf_counter()
        per_batch.append({"ari": ari, "mse": mse, "loss_s": t1 - t0,
                          "gen_s": t2 - t1 if gen_mse else 0.0})
    if not per_batch:
        return {"ari": float("nan"), "mse": float("nan"), "batches": []}
    return {"ari": float(np.mean([b["ari"] for b in per_batch])),
            "mse": float(np.mean([b["mse"] for b in per_batch])),
            "batches": per_batch}


def main(config: GetAriMseConfig, data: dict,
         device: str | torch.device | None = None) -> dict:
    """Build the OCR of ``config`` (weights from ``config.ocr_checkpoint``),
    evaluate it on ``data`` ({"obss", "masks"} arrays) in batches of
    ``config.batch_size`` and return {"ari", "mse", "batches"}."""
    if config.ocr.name not in SCORED:
        _refuse_unmasked(config.ocr.name)
    if config.bg_mask_idx != -1:
        raise ValueError("the foreground ARI takes the background as the last mask "
                         f"(bg_mask_idx -1), not {config.bg_mask_idx}")
    ocr, pretrained = get_ocr(config.ocr, config.env, config.ocr_checkpoint,
                              config.seed, device)
    if not pretrained:
        log.warning("no ocr_checkpoint configured; evaluating an untrained OCR")
    results = evaluate(ocr, batches_of(data, config.batch_size), config.seed,
                       with_gen_mse=config.with_gen_mse)
    log.info("ARI %.4f  MSE %.4f", results["ari"], results["mse"])
    return results
