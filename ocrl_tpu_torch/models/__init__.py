"""OCR models of the port (so far: SLATE and Slot-Attention, served, trained
and evaluated; GT, the ground-truth state)."""

from __future__ import annotations

import torch

from ..config import EnvConfig, GTConfig, OCRConfig
from ..device import resolve_device
from . import gt, slate
from .base import OCR
from .gt import GT_Module
from .slate import SLATE_Module, make_optimizer

__all__ = ["GT_Module", "OCR", "SLATE_Module", "create_ocr", "dims", "make_optimizer"]
LATER = "the slice that ports the other OCRs"


def dims(ocr_config, env_config) -> tuple[int, int]:
    """(representation size, number of slots or rows) of the OCR's output."""
    if ocr_config.name == "GT":
        return gt.dims(ocr_config, env_config)
    if ocr_config.name == "SLATE":
        return slate.dims(ocr_config, env_config)
    raise NotImplementedError(f"OCR '{ocr_config.name}' comes with {LATER}")


def create_ocr(ocr_config: OCRConfig | GTConfig, env_config: EnvConfig, seed: int = 0,
               device: str | torch.device | None = None) -> OCR:
    """The OCR of ``ocr_config`` with its optimizer, on ``device`` (CUDA
    unless asked otherwise; with no card and no device this raises). The
    weights are drawn on the CPU from ``seed``, so a seed gives the same
    weights on every device (counterpart of ocrl_tpu/models/__init__.py).
    GT has no optimizer, as in JAX: it takes no training step."""
    device = resolve_device(device)
    if ocr_config.name == "GT":
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            module = GT_Module(ocr_config, env_config)
        return OCR(module.to(device), None, None, seed, device)
    if ocr_config.name != "SLATE":
        raise NotImplementedError(f"OCR '{ocr_config.name}' comes with {LATER}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = SLATE_Module(ocr_config, env_config, decoder=True)
    module = module.to(device)
    return OCR(module, make_optimizer(module, ocr_config), ocr_config.learning.clip,
               seed, device)
