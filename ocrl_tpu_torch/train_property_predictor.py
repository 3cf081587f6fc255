"""Property-probe entry point of the port (counterpart of the repo-root
train_property_predictor.py:23-59):

    python -m ocrl_tpu_torch.train_property_predictor ocr=slate \\
        dataset=target-N4C4S3S1 ocr_checkpoint.local_file=<ckpt> \\
        dataset.datadir=<file with objs>

The dataset is an OCRL HDF5 file with the objects' state rows (``objs``),
collected with ``collection.with_states=True``; a batch without them raises
``KeyError``. The OCR is built by ``utils.checkpoint.get_ocr`` from
``ocr_checkpoint`` (its optimizer state too, which the probe's file carries
on), with a warning when none is configured; ``utils.property_predictor``
trains the head. Every step logs ``train/<metric>``; each epoch ends with
the mean of every metric over the validation batches (``val/<metric>``),
and on a new best ``val/loss`` the probe's JAX tree goes to
``<run_dir>/checkpoints/model_best.ckpt`` with the metadata step, epoch and
best_val_loss.
"""

from __future__ import annotations

import sys
import time
import warnings
from pathlib import Path

import numpy as np

from .config import TrainPropertyPredictorConfig, compose
from .data import get_dataloaders, prefetch_to_device
from .device import resolve_device
from .utils.checkpoint import get_ocr, save_checkpoint
from .utils.logger import Run
from .utils.property_predictor import PropertyPredictor


def train(config: TrainPropertyPredictorConfig, device=None) -> dict:
    """Train as ``config`` says on ``device`` (CUDA unless asked otherwise).
    Returns the ``probe``, the last ``step`` and ``epoch``, the
    ``best_val_loss`` and the ``run_dir``."""
    device = resolve_device(device)
    name = f"{config.ocr.name}-{config.dataset.name}"
    run_dir = config.run_dir or (f"outputs/train_property_predictor/{name}/"
                                 f"{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    run = Run(run_dir, f"TrainPropertyPredictor-{name}", config)
    train_dl, val_dl = get_dataloaders(config.dataset, config.batch_size, config.num_workers,
                                       seed=config.seed)
    ocr, pretrained = get_ocr(config.ocr, config.dataset, config.ocr_checkpoint,
                              seed=config.seed, device=device)
    if not pretrained:
        warnings.warn("no ocr_checkpoint configured; probing an untrained OCR", stacklevel=2)
    probe = PropertyPredictor(ocr, config.property_predictor, config.dataset, seed=config.seed)

    step, epoch, best_val = 0, 0, float("inf")
    for epoch in range(config.max_epochs):
        for batch in prefetch_to_device(train_dl, device, size=2):
            if "objs" not in batch:
                raise KeyError("dataset has no 'objs' key; collect it with "
                               "collection.with_states=True")
            metrics = probe.update(batch, step)
            run.log({f"train/{k}": v for k, v in metrics.items()}, step=step)
            step += 1
            if step % 200 == 0:
                print(f"epoch {epoch} step {step} "
                      + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
        vals = [probe.get_loss(b) for b in prefetch_to_device(val_dl, device, size=2)]
        val = {k: float(np.mean([m[k] for m in vals])) for k in vals[0]}
        run.log({f"val/{k}": v for k, v in val.items()}, step=step)
        print(f"[epoch {epoch}] val " + " ".join(f"{k} {v:.4f}" for k, v in val.items()),
              flush=True)
        if val["loss"] < best_val:
            best_val = val["loss"]
            save_checkpoint(Path(run.dir) / "checkpoints" / "model_best.ckpt", probe.save(),
                            {"step": step, "epoch": epoch, "best_val_loss": best_val})
    return {"probe": probe, "step": step, "epoch": epoch, "best_val_loss": best_val,
            "run_dir": run.dir}


def main(argv=None, device=None) -> dict:
    """``train`` of the config that ``argv`` (default: the command line)
    composes over ``TrainPropertyPredictorConfig``."""
    config = compose(TrainPropertyPredictorConfig(), sys.argv[1:] if argv is None else argv)
    result = train(config, device)
    print({"step": result["step"], "epoch": result["epoch"],
           "best_val_loss": result["best_val_loss"], "run_dir": str(result["run_dir"])},
          flush=True)
    return result


if __name__ == "__main__":
    main()
