"""The ground-truth state as the representation (counterpart of
ocrl_tpu/models/gt.py): the env's state rows as they are, or through an MLP
when ``ocr.dims`` is not empty."""

from __future__ import annotations

import torch
from torch import nn

from ..config import GTConfig, SyntheticEnvConfig
from .common import lecun_normal_

_ACTS = {"relu": torch.relu, "tanh": torch.tanh, "none": None, "linear": None, None: None}


def _dense(in_features: int, out_features: int) -> nn.Linear:
    """flax nn.Dense: lecun-normal kernel, zero bias."""
    m = nn.Linear(in_features, out_features)
    lecun_normal_(m.weight)
    nn.init.zeros_(m.bias)
    return m


class GT_Module(nn.Module):
    def __init__(self, ocr_config: GTConfig, env_config: SyntheticEnvConfig):
        super().__init__()
        for act in ocr_config.acts:
            if act not in _ACTS:
                raise ValueError(f"activation '{act}' is not implemented")
        dims = (env_config.state_size,) + tuple(ocr_config.dims)
        self.mlp = nn.ModuleList(_dense(a, b) for a, b in zip(dims, dims[1:]))
        self._acts = tuple(ocr_config.acts)

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, rows, state_size] -> [B, rows, rep_dim]; ``noise`` and
        ``generator`` are taken for the policy's sake and unused."""
        x = obs
        for layer, act in zip(self.mlp, self._acts):
            x = layer(x)
            if _ACTS[act] is not None:
                x = _ACTS[act](x)
        return x


def dims(ocr_config: GTConfig, env_config: SyntheticEnvConfig) -> tuple[int, int]:
    """(representation size, number of rows): Push and Maze states carry a
    goal row besides the objects and the agent."""
    if "Push" in env_config.name or "Maze" in env_config.name:
        num_slots = env_config.num_objects_range[1] + 2
    else:
        num_slots = env_config.num_objects_range[1] + 1
    rep_dim = ocr_config.dims[-1] if len(ocr_config.dims) > 0 else env_config.state_size
    return rep_dim, num_slots
