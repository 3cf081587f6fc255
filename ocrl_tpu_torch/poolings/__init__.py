"""Poolings of the port: Transformer, RN, MLP, CNN_Linear, CNN_Transformer
and Identity, and the wrapper that pairs one with an OCR (``Pooling``)."""

from .modules import (CNN_Linear_Module, CNN_Transformer_Module, Identity_Module, MLP_Module,
                      RN_Module, Transformer_Module, create_pooling_module, pooled_dim)
from ..utils.checkpoint import get_ocr
from .wrapper import Pooling

__all__ = ["CNN_Linear_Module", "CNN_Transformer_Module", "Identity_Module", "MLP_Module",
           "Pooling", "RN_Module", "Transformer_Module", "create_pooling_module", "get_ocr",
           "pooled_dim"]
