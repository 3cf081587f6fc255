"""OCR models of the port: SLATE and Slot-Attention (served, pretrained
and evaluated), GT (the ground-truth state), NatureCNN and MultipleCNN
(served and trained end to end on the RL path; their pretraining step
leaves them as they are, as in JAX), VAE, MAE and IODINE (served, trained
end to end on the RL path, and pretrained; IODINE also evaluated)."""

from __future__ import annotations

import torch
from torch import nn

from ..config import EnvConfig, OCRConfigs
from ..device import resolve_device
from . import gt, iodine, mae, multiple_cnn, naturecnn, slate, vae
from .base import OCR, MultiGroupAdam, constant
from .gt import GT_Module
from .iodine import Iodine_Module
from .mae import MAE_Module
from .multiple_cnn import MultipleCNN_Module
from .naturecnn import NatureCNN_Module
from .slate import SLATE_Module, make_optimizer
from .vae import VAE_Module

__all__ = ["GT_Module", "Iodine_Module", "MAE_Module", "MultipleCNN_Module",
           "NatureCNN_Module", "OCR", "SLATE_Module", "VAE_Module", "build_module",
           "create_ocr", "dims", "make_optimizer"]

# name -> (module of dims(), module class, whether it takes decoder=)
_REGISTRY = {
    "SLATE": (slate, SLATE_Module, True),
    "GT": (gt, GT_Module, False),
    "NatureCNN": (naturecnn, NatureCNN_Module, False),
    "MultipleCNN": (multiple_cnn, MultipleCNN_Module, False),
    "VAE": (vae, VAE_Module, True),
    "MAE": (mae, MAE_Module, True),
    "Iodine": (iodine, Iodine_Module, False),
}


def _entry(ocr_config):
    if ocr_config.name not in _REGISTRY:
        raise ValueError(f"Unknown OCR model '{ocr_config.name}'. "
                         f"Available: {sorted(_REGISTRY)}")
    return _REGISTRY[ocr_config.name]


def dims(ocr_config, env_config) -> tuple[int, int]:
    """(representation size, number of slots or rows) of the OCR's output."""
    return _entry(ocr_config)[0].dims(ocr_config, env_config)


def build_module(ocr_config: OCRConfigs, env_config: EnvConfig, *,
                 decoder: bool = False) -> nn.Module:
    """The OCR's module on the CPU, weights from torch's global generator:
    the policy's (what the representation reads) or, with ``decoder``, the
    whole model a checkpoint holds."""
    _, cls, takes_decoder = _entry(ocr_config)
    if takes_decoder:
        return cls(ocr_config, env_config, decoder=decoder)
    return cls(ocr_config, env_config)


def create_ocr(ocr_config: OCRConfigs, env_config: EnvConfig, seed: int = 0,
               device: str | torch.device | None = None) -> OCR:
    """The OCR of ``ocr_config`` with its optimizer, on ``device`` (CUDA
    unless asked otherwise; with no card and no device this raises). The
    weights are drawn on the CPU from ``seed``, so a seed gives the same
    weights on every device (counterpart of ocrl_tpu/models/__init__.py).
    Each OCR gets the optimizer and clip of its JAX ``build_spec``: SLATE
    its three Adam groups and the inf-norm clip, MAE its AdamW, IODINE Adam
    and the 2-norm clip of its config, the VAE, NatureCNN and MultipleCNN
    Adam, unclipped; GT none (it takes no training step). The handle also
    carries JAX's ``name``, ``rep_dim`` and ``num_slots``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = build_module(ocr_config, env_config, decoder=True).to(device)
    ocr = _handle(module, ocr_config, seed, device)
    ocr.name = ocr_config.name
    ocr.rep_dim, ocr.num_slots = dims(ocr_config, env_config)
    return ocr


def _handle(module: nn.Module, ocr_config: OCRConfigs, seed: int, device) -> OCR:
    name = ocr_config.name
    if name == "GT":
        return OCR(module, None, None, seed, device)
    learning = ocr_config.learning
    if name == "SLATE":
        return OCR(module, make_optimizer(module, ocr_config), learning.clip, seed, device)
    if name == "MAE":
        return OCR(module, mae.make_optimizer(module, ocr_config), None, seed, device)
    adam = MultiGroupAdam({"all": (list(module.parameters()), constant(learning.lr), 0.0)})
    if name == "Iodine":
        return OCR(module, adam, learning.clip, seed, device, learning.clip_norm_type)
    return OCR(module, adam, None, seed, device)

