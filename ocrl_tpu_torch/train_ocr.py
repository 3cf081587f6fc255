"""OCR pretraining entry point of the port (counterpart of the repo-root
train_ocr.py:24-156):

    python -m ocrl_tpu_torch.train_ocr ocr=slate dataset=random-N5C4S4S2 \\
        dataset.datadir=<file> max_steps=64

The dataset is an OCRL HDF5 file as the collectors write it
(``python -m ocrl_tpu_torch.collect_dataset_from_synthetic_envs``), served
by ``data.get_dataloaders`` and staged on the card by
``data.prefetch_to_device`` in superbatches of ``superbatch`` batches, each
taken by ``OCR.update_many`` (k > 1) or ``OCR.update``. Metrics stay on the
card until a flush brings them to the host in one copy: at each
``log_interval`` crossing, while the previous step is below 3, before each
evaluation and at each epoch's end; the flush logs ``train/<name>`` for every
step. At each ``eval_interval`` crossing ``eval_and_save`` runs the
validation set (every batch, the partial last one too) and logs ``val/*``,
the mean of the per-batch means, and ``val/best_loss``; on a new best it
logs sample images of the last batch; then it writes the checkpoints
(``utils.checkpoint.save``: JAX's file format and trees). A run resumes from
``load.resume_checkpoint``, ``load.resume_run_path`` or its own
``run_dir``'s latest file, JAX's or the port's. ``max_steps`` stops the run
mid-epoch and evaluates and saves once more. ``profile_dir`` writes a
torch.profiler trace of steps 10 to 15 + superbatch there, which carries
the program's own ranges beside the ops (``utils.tracing``: ``ocrl.step``
and its forward, backward and optimizer). The printed images/s is the rate
over the steps since the previous print (or since the epoch's first
superbatch or the last evaluation), so neither the loader's start nor an
evaluation is counted in it.

Two behaviours of the reference are kept as they are (ROADMAP.md, suspected
faults of the reference): a resumed run builds its train loader afresh, so
the shuffle restarts at the loader's epoch 0 whatever epoch it resumes; and
where ``max_steps`` lands on an ``eval_interval`` crossing, evaluation and
saving run twice at that step.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import OCRConfigs, TrainOCRConfig, compose
from .data import get_dataloaders, prefetch_to_device
from .device import resolve_device
from .models import create_ocr
from .utils.checkpoint import load, save
from .utils.logger import Image, Run, log_prefix


def pretraining_config(ocr_config: OCRConfigs, batch_size: int) -> OCRConfigs:
    """The OCR config as the entry point trains it: MAE's learning rate
    scaled by batch_size / 256 (train_ocr.py:34-36), the others as they are."""
    if ocr_config.name != "MAE":
        return ocr_config
    learning = dataclasses.replace(ocr_config.learning,
                                   lr=ocr_config.learning.lr * batch_size / 256)
    return dataclasses.replace(ocr_config, learning=learning)


def _to_host(values: list[dict]) -> list[dict[str, np.ndarray]]:
    """Each dict of metrics (tensors on the device, 0-d or (k,)) as numpy,
    all of them brought over in one copy."""
    flat = [(i, k, torch.as_tensor(v)) for i, m in enumerate(values) for k, v in m.items()]
    if not flat:
        return [{} for _ in values]
    device = flat[0][2].device
    joined = torch.cat([v.reshape(-1).to(device, torch.float64) for _, _, v in flat]).cpu()
    out: list[dict[str, np.ndarray]] = [{} for _ in values]
    at = 0
    for i, k, v in flat:
        out[i][k] = joined[at:at + v.numel()].numpy()
        at += v.numel()
    return out


def eval_and_save(model, val_dl, epoch: int, step: int, best_val_loss: float,
                  config: TrainOCRConfig, run: Run) -> float:
    """Validation over every batch, its metrics logged at ``step``, samples
    on a new best, then the checkpoints (train_ocr.py:131-154). Returns the
    best validation loss."""
    per_batch, last_batch = [], None
    for batch in prefetch_to_device(val_dl, model.device, size=2):
        m = model.get_loss(batch["obss"], batch.get("masks"))
        per_batch.append({k: torch.as_tensor(v).to(torch.float32).mean() for k, v in m.items()})
        last_batch = batch
    host = [{k: float(v[0]) for k, v in m.items()} for m in _to_host(per_batch)]
    metrics = {k: float(np.mean([m[k] for m in host])) for k in host[0]} if host else {}
    best = bool(metrics) and metrics.get("loss", np.inf) < best_val_loss
    if best:
        best_val_loss = metrics["loss"]
    metrics["best_loss"] = best_val_loss
    run.log({f"val/{k}": v for k, v in metrics.items()}, step=step)
    print(f"[Epoch {epoch}, Step {step}] "
          + " / ".join(f"val/{k} {v:.4f}" for k, v in metrics.items()), flush=True)
    if best and last_batch is not None:
        samples = model.get_samples(last_batch["obss"][:config.num_visualization])
        run.log({k: [Image(v_) for v_ in v] for k, v in samples.items()}, step=step)
    save(model, run.dir, step=step, epoch=epoch, best_val_loss=best_val_loss, best=best)
    return best_val_loss


def train(config: TrainOCRConfig, device=None) -> dict:
    """Train as ``config`` says on ``device`` (CUDA unless asked otherwise).
    Returns the ``model``, the last ``step`` and ``epoch``, the
    ``best_val_loss`` and the ``run_dir``."""
    device = resolve_device(device)
    log_name = log_prefix(config) + f"-{config.dataset.name}"
    tags = config.tags.split(",") + config.dataset.tags.split(",")
    run_dir = config.run_dir or (
        f"outputs/train_ocr/{config.ocr.name}-{config.dataset.name}/"
        f"{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    run = Run(run_dir, "TrainOCR-" + log_name, config, tags)

    train_dl, val_dl = get_dataloaders(config.dataset, config.batch_size,
                                       config.num_workers, seed=config.seed)
    model = create_ocr(pretraining_config(config.ocr, config.batch_size), config.dataset,
                       config.seed, device)
    step, epoch, best_val_loss = load(model, run_dir=run.dir,
                                      resume_checkpoint=config.load.resume_checkpoint,
                                      resume_run_path=config.load.resume_run_path)

    pending: list[tuple[int, int, dict]] = []

    def flush_pending() -> None:
        for (s, k, _), vals in zip(pending, _to_host([m for _, _, m in pending])):
            for j in range(k):
                run.log({f"train/{name}": float(v[j if v.size > 1 else 0])
                         for name, v in vals.items()}, step=s + j)
        pending.clear()

    superbatch, batch_size = int(config.superbatch), int(config.batch_size)
    log_interval, eval_interval = int(config.log_interval), int(config.eval_interval)
    max_steps = None if config.max_steps is None else int(float(config.max_steps))
    profile_dir, profiler = config.profile_dir, None
    while epoch < config.max_epochs and (max_steps is None or step < max_steps):
        since, imgs = None, 0
        for batch in prefetch_to_device(train_dl, device, size=2, superbatch=superbatch,
                                        yield_whole=True):
            since = since or time.time()
            if profile_dir and profiler is None and step >= 10:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])])
                profiler.start()
            masks = batch.get("masks")
            k = batch["obss"].shape[0] // batch_size
            if k > 1:
                metrics = model.update_many(batch["obss"], masks, step, k)
            else:
                metrics = model.update(batch["obss"], masks, step)
            imgs += batch["obss"].shape[0]
            pending.append((step, k, metrics))
            prev_step, step = step, step + k
            if profiler is not None and step >= 15 + superbatch:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                Path(profile_dir).mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
                print(f"profiler trace written to {profile_dir}", flush=True)
                profile_dir, profiler = None, None      # one window a run
            if step // log_interval != prev_step // log_interval or prev_step < 3:
                flush_pending()
                loss = metrics.get("loss", 0.0)
                loss = float(torch.as_tensor(loss).reshape(-1)[-1])
                print(f"epoch {epoch} step {step} loss {loss:.4f} "
                      f"({imgs / (time.time() - since):.1f} imgs/s)", flush=True)
                since, imgs = time.time(), 0
            if step // eval_interval != prev_step // eval_interval:
                flush_pending()
                best_val_loss = eval_and_save(model, val_dl, epoch, step, best_val_loss,
                                              config, run)
                since, imgs = time.time(), 0
            if max_steps is not None and step >= max_steps:
                break
        epoch += 1
        flush_pending()
        run.log({"epoch": epoch}, step=step)
    if max_steps is not None and step >= max_steps:
        # the final evaluation and save at the budget (train_ocr.py:125-128)
        eval_and_save(model, val_dl, epoch, step, best_val_loss, config, run)
    return {"model": model, "step": step, "epoch": epoch, "best_val_loss": best_val_loss,
            "run_dir": run.dir}


def main(argv=None, device=None) -> dict:
    """``train`` of the config that ``argv`` (default: the command line)
    composes over ``TrainOCRConfig``."""
    result = train(compose(TrainOCRConfig(), sys.argv[1:] if argv is None else argv), device)
    print({"step": result["step"], "epoch": result["epoch"],
           "best_val_loss": result["best_val_loss"], "run_dir": str(result["run_dir"])},
          flush=True)
    return result


if __name__ == "__main__":
    main()
