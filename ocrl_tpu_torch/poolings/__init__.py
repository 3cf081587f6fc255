"""Poolings of the port: Transformer, RN, MLP, CNN_Linear, CNN_Transformer
and Identity."""

from .modules import (CNN_Linear_Module, CNN_Transformer_Module, Identity_Module, MLP_Module,
                      RN_Module, Transformer_Module, create_pooling_module, pooled_dim)

__all__ = ["CNN_Linear_Module", "CNN_Transformer_Module", "Identity_Module", "MLP_Module",
           "RN_Module", "Transformer_Module", "create_pooling_module", "pooled_dim"]
