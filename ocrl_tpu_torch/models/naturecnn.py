"""The Nature DQN CNN (counterpart of ocrl_tpu/models/naturecnn.py), trained
end to end with the policy: three VALID convolutions with ReLU (a fourth,
128 wide, when ``cnn_feat_size`` is 2), then a ReLU Dense of ``rep_dim``,
or with ``use_cnn_feat`` the 4x4 (2x2) feature map as 16 (4) pseudo-slots.
NHWC observations; the map is flattened as H, W, C before the Dense, as JAX
does."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EnvConfig, NatureCNNConfig
from .common import dense, flax_conv


def nature_convs(in_channels: int, feat_size: int = 4) -> nn.ModuleList:
    convs = [flax_conv(in_channels, 32, 8, 4), flax_conv(32, 64, 4, 2), flax_conv(64, 64, 3, 1)]
    if feat_size == 2:
        convs.append(flax_conv(64, 128, 3, 1))
    return nn.ModuleList(convs)


def conv_out_size(size: int, convs: nn.ModuleList) -> int:
    for conv in convs:
        size = (size - conv.kernel_size[0]) // conv.stride[0] + 1
    return size


class NatureCNN(nn.Module):
    """The Nature CNN over NHWC images of ``size`` with ``in_channels``:
    VALID convolutions with ReLU, then (``rep_dim`` given) the map
    flattened as H, W, C and a ReLU Dense, else the map itself, NHWC. Also
    the CNN poolings' (ocrl_tpu/poolings/modules.py:198-213)."""

    def __init__(self, in_channels: int, size: int, rep_dim: int | None, feat_size: int = 4):
        super().__init__()
        self.convs = nature_convs(in_channels, feat_size)
        size = conv_out_size(size, self.convs)
        width = self.convs[-1].out_channels
        self.dense = None if rep_dim is None else dense(width * size * size, rep_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1)
        if self.dense is None:
            return x
        return F.relu(self.dense(x.reshape(x.shape[0], -1)))


class NatureCNN_Module(NatureCNN):
    def __init__(self, ocr_config: NatureCNNConfig, env_config: EnvConfig):
        feat = ocr_config.use_cnn_feat
        super().__init__(env_config.obs_channels * env_config.num_stacked_obss,
                         env_config.obs_size, None if feat else ocr_config.rep_dim,
                         ocr_config.cnn_feat_size)
        self.use_cnn_feat = feat

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, H, W, C] in [0, 1] -> [B, rep_dim], or [B, s*s, width]
        with ``use_cnn_feat``; ``noise`` and ``generator`` are unused."""
        x = super().forward(obs)
        return x.reshape(x.shape[0], -1, x.shape[-1]) if self.use_cnn_feat else x

    def loss(self, obs: torch.Tensor, masks=None, step: int = 0, train: bool = False, *,
             generator=None, noise=None):
        """No pretraining loss: 0 * sum(rep) and no metrics, as in JAX, so
        that a step leaves the parameters where they are (it trains end to
        end with the policy)."""
        return 0.0 * self(obs).sum(), {}


def dims(ocr_config: NatureCNNConfig, env_config: EnvConfig) -> tuple[int, int]:
    if ocr_config.use_cnn_feat:
        if ocr_config.cnn_feat_size == 4:
            return 64, 16
        if ocr_config.cnn_feat_size == 2:
            return 128, 4
        raise ValueError("cnn_feat_size must be 2 or 4")
    return ocr_config.rep_dim, 1
