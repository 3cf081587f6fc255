"""OCR models of the port (so far: SLATE and Slot-Attention, served, trained
and evaluated)."""

from __future__ import annotations

import torch

from ..config import EnvConfig, OCRConfig
from ..device import resolve_device
from .base import OCR
from .slate import SLATE_Module, dims, make_optimizer

__all__ = ["OCR", "SLATE_Module", "create_ocr", "dims", "make_optimizer"]


def create_ocr(ocr_config: OCRConfig, env_config: EnvConfig, seed: int = 0,
               device: str | torch.device | None = None) -> OCR:
    """The OCR of ``ocr_config`` with its optimizer, on ``device`` (CUDA
    unless asked otherwise; with no card and no device this raises). The
    weights are drawn on the CPU from ``seed``, so a seed gives the same
    weights on every device (counterpart of ocrl_tpu/models/__init__.py)."""
    device = resolve_device(device)
    if ocr_config.name != "SLATE":
        raise NotImplementedError(
            f"OCR '{ocr_config.name}' comes with the slice that ports the other OCRs")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = SLATE_Module(ocr_config, env_config, decoder=True)
    module = module.to(device)
    return OCR(module, make_optimizer(module, ocr_config), ocr_config.learning.clip,
               seed, device)
