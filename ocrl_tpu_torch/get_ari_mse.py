"""Segmentation and reconstruction evaluation with the port (counterpart of
the repo-root get_ari_mse.py):

    python -m ocrl_tpu_torch.get_ari_mse ocr=slate dataset=random-N5C4S4S2 \
        dataset.datadir=<file with masks> ocr_checkpoint.local_file=<ckpt>

``main(argv, device)`` composes ``GetAriMseConfig`` from ``argv`` (default:
the command line), reads the file's ValidationSet through
``data.get_dataloaders`` (in file order, the last batch partial; any layout
``data.hdf5_format`` reads), stages the batches on the device through
``data.prefetch_to_device`` two ahead, builds the OCR with
``utils.checkpoint.get_ocr`` and logs ``eval/ari`` and ``eval/mse`` at step
0 into ``run_dir``'s metrics.jsonl (``utils.logger.Run``), then prints the
results, as JAX's entry does. It runs on the card unless ``device`` says
otherwise. ``evaluate_arrays(config, data, device)`` does the same on
arrays in memory ({"obss", "masks"}), without the file and the log, and
``evaluate(ocr, batches, seed)`` on an OCR and batches directly.

Per batch: the foreground ARI of ``OCR.get_loss(obs, masks)``, which draws
from the OCR's own generator; then for SLATE with the transformer decoder
the autoregressive MSE, sum((obs - gen_imgs(slots)) ** 2) / B, with the
slots of a second slot-attention pass on noise from a generator seeded by
``seed``; for ``use_bcdec`` and for IODINE the loss's ``mse`` instead. The
other OCRs produce no masks and raise ``ValueError``, and a batch without
masks raises ``KeyError``, as JAX's entry does. The results are the means
over the batches.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import torch

from .config import GetAriMseConfig, compose
from .data import get_dataloaders, prefetch_to_device
from .device import resolve_device
from .models.base import OCR, normalize_obs
from .models.iodine import Iodine_Module
from .models.slate import SLATE_Module
from .utils.checkpoint import get_ocr
from .utils.logger import Run

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
            obs = normalize_obs(torch.as_tensor(batch["obss"]).to(ocr.device))
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


def _scored_ocr(config: GetAriMseConfig, device) -> OCR:
    """The OCR of ``config`` (weights from ``config.ocr_checkpoint``), after
    the refusals of what cannot be scored."""
    if config.ocr.name not in SCORED:
        _refuse_unmasked(config.ocr.name)
    if config.bg_mask_idx != -1:
        raise ValueError("the foreground ARI takes the background as the last mask "
                         f"(bg_mask_idx -1), not {config.bg_mask_idx}")
    ocr, pretrained = get_ocr(config.ocr, config.dataset, config.ocr_checkpoint,
                              config.seed, device)
    if not pretrained:
        log.warning("no ocr_checkpoint configured; evaluating an untrained OCR")
    return ocr


def evaluate_arrays(config: GetAriMseConfig, data: dict,
                    device: str | torch.device | None = None) -> dict:
    """Build the OCR of ``config``, evaluate it on ``data`` ({"obss", "masks"}
    arrays) in batches of ``config.batch_size`` and return {"ari", "mse",
    "batches"}."""
    ocr = _scored_ocr(config, device)
    results = evaluate(ocr, batches_of(data, config.batch_size), config.seed,
                       with_gen_mse=config.with_gen_mse)
    log.info("ARI %.4f  MSE %.4f", results["ari"], results["mse"])
    return results


def main(argv=None, device=None) -> dict:
    """Evaluate as the config that ``argv`` (default: the command line)
    composes over ``GetAriMseConfig`` says, on its dataset file's
    ValidationSet, on ``device`` (CUDA unless asked otherwise); log the
    results at step 0, print {"ari", "mse"} and return {"ari", "mse",
    "batches", "run_dir"}."""
    logging.basicConfig(level=logging.INFO)
    config = compose(GetAriMseConfig(), sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    run_dir = config.run_dir or (
        f"outputs/get_ari/{config.ocr.name}-{config.dataset.name}/"
        f"{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    logger = Run(run_dir, f"GetAriMse-{config.ocr.name}-{config.dataset.name}", config)
    _, val_dl = get_dataloaders(config.dataset, config.batch_size, config.num_workers,
                                seed=config.seed)
    ocr = _scored_ocr(config, device)
    results = evaluate(ocr, prefetch_to_device(val_dl, device, size=2), config.seed,
                       with_gen_mse=config.with_gen_mse)
    logger.log({"eval/ari": results["ari"], "eval/mse": results["mse"]}, step=0)
    log.info("ARI %.4f  MSE %.4f", results["ari"], results["mse"])
    print({"ari": results["ari"], "mse": results["mse"]}, flush=True)
    return {**results, "run_dir": logger.dir}


if __name__ == "__main__":
    main()
