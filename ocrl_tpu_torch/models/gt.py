"""The ground-truth state as the representation (counterpart of
ocrl_tpu/models/gt.py): the env's state rows as they are, or through an MLP
when ``ocr.dims`` is not empty."""

from __future__ import annotations

import torch
from torch import nn

from ..config import GTConfig, SyntheticEnvConfig
from .common import MLP


class GT_Module(nn.Module):
    def __init__(self, ocr_config: GTConfig, env_config: SyntheticEnvConfig):
        super().__init__()
        self.mlp = MLP(env_config.state_size, ocr_config.dims, ocr_config.acts)

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, rows, state_size] -> [B, rows, rep_dim]; ``noise`` and
        ``generator`` are taken for the policy's sake and unused."""
        return self.mlp(obs)


def dims(ocr_config: GTConfig, env_config: SyntheticEnvConfig) -> tuple[int, int]:
    """(representation size, number of rows): Push and Maze states carry a
    goal row besides the objects and the agent."""
    if "Push" in env_config.name or "Maze" in env_config.name:
        num_slots = env_config.num_objects_range[1] + 2
    else:
        num_slots = env_config.num_objects_range[1] + 1
    rep_dim = ocr_config.dims[-1] if len(ocr_config.dims) > 0 else env_config.state_size
    return rep_dim, num_slots
