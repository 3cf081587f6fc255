"""Classification-probe entry point of the port (counterpart of the
repo-root train_classifier.py:28-110):

    python -m ocrl_tpu_torch.train_classifier ocr=slate pooling=transformer \\
        dataset=target-N4C4S3S1 pooling.ocr_checkpoint.local_file=<ckpt> \\
        dataset.datadir=<file with labels>

A pooling and a head (Dense d_model, relu, Dense num_labels) learn each
image's label (``labels[:, 0]``, collected with
``collection.with_labels=True``) from the OCR's representation, by the
cross-entropy and one Adam over the pooling and the head together.

As in JAX the OCR stays outside the optimizer and is never differentiated,
whatever ``pooling.learn_downstream_loss`` or ``learn_aux_loss`` say
(train_classifier.py:52-70): its forward runs without autograd. The pooling
that trains is a copy of the ``Pooling`` wrapper's, whose own parameters
and Adam state stay at their init; ``model_best.ckpt`` holds
``classifier_params`` ({pooling, head}, trained) beside ``pooling.save()``
(the init) and the OCR's, with the metadata step, epoch, best_val_loss and
val_acc (ROADMAP.md, suspected faults of the reference).
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import TrainClassifierConfig, compose
from .data import get_dataloaders, prefetch_to_device
from .device import resolve_device
from .models.common import dense
from .poolings import Pooling
from .rl.ppo import OptaxChain
from .utils.checkpoint import get_ocr, save_checkpoint
from .utils.convert import attention_heads, part_to_flax
from .utils.logger import Run


class ClassifierHead(nn.Module):
    """flax's ``ClassifierHead``: Dense d_model, relu, Dense num_labels."""

    def __init__(self, in_dim: int, d_model: int, num_labels: int):
        super().__init__()
        self.dense = nn.ModuleList([dense(in_dim, d_model), dense(d_model, num_labels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense[1](torch.relu(self.dense[0](x)))


class Classifier:
    """The trained part of the probe: a copy of ``pooling``'s module, the
    head (weights drawn on the CPU from ``seed``) and one Adam over both."""

    def __init__(self, pooling: Pooling, ocr, d_model: int, num_labels: int, lr: float,
                 seed: int = 0):
        self.ocr = ocr
        self.pooling = copy.deepcopy(pooling.module)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.head = ClassifierHead(pooling.rep_dim, d_model, num_labels).to(pooling.device)
        self.params = list(self.pooling.parameters()) + list(self.head.parameters())
        self.optimizer = OptaxChain(self.params, "adam", lr, None, 1e-8)

    def _loss(self, batch: dict, noise: dict | None):
        """(cross-entropy, accuracy) of a batch, the graph into the pooling
        and the head; the OCR runs without autograd, ``noise`` as
        ``OCR.rep`` takes it."""
        ocr = self.ocr
        labels = torch.as_tensor(batch["labels"]).to(ocr.device)[:, 0].to(torch.int64)
        rep = ocr.rep(batch["obss"], noise=noise)
        logits = self.head(self.pooling(rep))
        ce = F.cross_entropy(logits, labels)
        acc = (logits.detach().argmax(-1) == labels).to(torch.float32).mean()
        return ce, acc

    def step(self, batch: dict, *, noise: dict | None = None) -> tuple[float, float]:
        """One Adam step; (loss, accuracy) before it."""
        ce, acc = self._loss(batch, noise)
        self.optimizer.step(torch.autograd.grad(ce, self.params))
        return tuple(torch.stack([ce.detach(), acc]).cpu().tolist())

    def evaluate(self, batch: dict, *, noise: dict | None = None) -> tuple[float, float]:
        with torch.no_grad():
            ce, acc = self._loss(batch, noise)
        return tuple(torch.stack([ce, acc]).cpu().tolist())

    def params_tree(self) -> dict:
        """JAX's ``{"pooling", "head"}`` parameter tree."""
        return {"pooling": part_to_flax("pooling_module", self.pooling.state_dict(),
                                        attention_heads(self.pooling)),
                "head": part_to_flax("head", self.head.state_dict())}


def train(config: TrainClassifierConfig, device=None) -> dict:
    """Train as ``config`` says on ``device`` (CUDA unless asked otherwise).
    Returns the ``classifier``, the ``pooling`` wrapper, the last ``step``
    and ``epoch``, the ``best_val_loss`` and the ``run_dir``."""
    device = resolve_device(device)
    name = f"{config.ocr.name}-{config.pooling.name}-{config.dataset.name}"
    run_dir = config.run_dir or (f"outputs/train_classifier/{name}/"
                                 f"{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    run = Run(run_dir, f"TrainClassifier-{name}", config)
    train_dl, val_dl = get_dataloaders(config.dataset, config.batch_size, config.num_workers,
                                       seed=config.seed)
    ocr, _ = get_ocr(config.ocr, config.dataset, config.pooling.ocr_checkpoint,
                     seed=config.seed, device=device)
    pooling = Pooling(ocr, config.pooling, seed=config.seed)
    classifier = Classifier(pooling, ocr, config.classifier.d_model, config.dataset.num_labels,
                            config.classifier.learning.lr, seed=config.seed)

    step, epoch, best_val = 0, 0, float("inf")
    for epoch in range(config.max_epochs):
        for batch in prefetch_to_device(train_dl, device, size=2):
            loss, acc = classifier.step(batch)
            run.log({"train/loss": loss, "train/acc": acc}, step=step)
            step += 1
            if step % 200 == 0:
                print(f"epoch {epoch} step {step} loss {loss:.4f} acc {acc:.3f}", flush=True)
        results = [classifier.evaluate(b) for b in prefetch_to_device(val_dl, device, size=2)]
        val_loss = float(np.mean([r[0] for r in results]))
        val_acc = float(np.mean([r[1] for r in results]))
        run.log({"val/loss": val_loss, "val/acc": val_acc}, step=step)
        print(f"[epoch {epoch}] val loss {val_loss:.4f} acc {val_acc:.3f}", flush=True)
        if val_loss < best_val:
            best_val = val_loss
            ckpt = {"classifier_params": classifier.params_tree()}
            ckpt.update(pooling.save())
            save_checkpoint(Path(run.dir) / "checkpoints" / "model_best.ckpt", ckpt,
                            {"step": step, "epoch": epoch, "best_val_loss": best_val,
                             "val_acc": val_acc})
    return {"classifier": classifier, "pooling": pooling, "step": step, "epoch": epoch,
            "best_val_loss": best_val, "run_dir": run.dir}


def main(argv=None, device=None) -> dict:
    """``train`` of the config that ``argv`` (default: the command line)
    composes over ``TrainClassifierConfig``."""
    config = compose(TrainClassifierConfig(), sys.argv[1:] if argv is None else argv)
    result = train(config, device)
    print({"step": result["step"], "epoch": result["epoch"],
           "best_val_loss": result["best_val_loss"], "run_dir": str(result["run_dir"])},
          flush=True)
    return result


if __name__ == "__main__":
    main()
