"""K independent Nature CNNs as K slots (counterpart of
ocrl_tpu/models/multiple_cnn.py, where one NatureCNN is ``nn.vmap``-ed
over the module axis): [B, H, W, C] -> [B, K, rep_dim].

The K networks run together: the first convolution, whose input they
share, as one convolution of K x 32 outputs; the second and third as
grouped convolutions (K groups); the Dense as one batched product over the
module axis. Channel block k of each convolution and slice k of the Dense
are module k's, i.e. slice k of each vmapped JAX leaf."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EnvConfig, MultipleCNNConfig
from .common import flax_conv, lecun_normal_
from .naturecnn import conv_out_size


class StackedDense(nn.Module):
    """K Dense layers of the same shape: ``weight`` [K, out, in], ``bias``
    [K, out]; [B, K, in] -> [B, K, out]."""

    def __init__(self, K: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(K, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(K, out_features))
        for k in range(K):
            lecun_normal_(self.weight.data[k])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bki,koi->bko", x, self.weight) + self.bias


class MultipleCNN_Module(nn.Module):
    def __init__(self, ocr_config: MultipleCNNConfig, env_config: EnvConfig):
        super().__init__()
        K = self.num_modules = ocr_config.num_modules
        channels = env_config.obs_channels * env_config.num_stacked_obss
        self.convs = nn.ModuleList([flax_conv(channels, K * 32, 8, 4),
                                    flax_conv(K * 32, K * 64, 4, 2, groups=K),
                                    flax_conv(K * 64, K * 64, 3, 1, groups=K)])
        size = conv_out_size(env_config.obs_size, self.convs)
        self.dense = StackedDense(K, 64 * size * size, ocr_config.rep_dim)

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, H, W, C] in [0, 1] -> [B, K, rep_dim]; ``noise`` and
        ``generator`` are unused."""
        x = obs.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        B, _, H, W = x.shape
        x = x.view(B, self.num_modules, -1, H, W).permute(0, 1, 3, 4, 2)   # [B, K, H, W, C]
        return F.relu(self.dense(x.reshape(B, self.num_modules, -1)))

    def loss(self, obs: torch.Tensor, masks=None, step: int = 0, train: bool = False, *,
             generator=None, noise=None):
        """No pretraining loss: 0 * sum(rep) and no metrics, as in JAX, so
        that a step leaves the parameters where they are (it trains end to
        end with the policy)."""
        return 0.0 * self(obs).sum(), {}


def dims(ocr_config: MultipleCNNConfig, env_config: EnvConfig) -> tuple[int, int]:
    return ocr_config.rep_dim, ocr_config.num_modules
