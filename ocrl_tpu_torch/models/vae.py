"""The convolutional VAE (counterpart of ocrl_tpu/models/vae.py): its
representation is the latent mean ``mu`` [B, latent_dim], or with
``use_cnn_feat`` the encoder's 4x4 map as 16 pseudo-slots [B, 16, 64].

``VAEEncoder``: log2(obs_size / cnn_feat_size) stages of a 2x2 stride-2
conv block and three 1x1 conv blocks, then a 1x1 conv to 64 (NHWC).
``VAEDecoder``: a 1x1 conv block, then per stage a 3x3 conv block, two 1x1
blocks and a 1x1 block to 256 channels (shuffled to twice the size), then a
1x1 conv to the image's channels. The policy's module (the default) holds
what the representation reads, as the JAX policy's parameter tree does
(``enc``, ``mu``, ``var``); with ``decoder=True`` it also holds ``in_dec``
and ``dec``, as a checkpoint does, and takes the pretraining ``loss``
(ocrl_tpu/models/vae.py:88-104): the reparameterised draw
mu + eps * exp(log_var / 2) decoded, its summed squared error over the
batch size, and the KL weighted by ``kld_weight``. ``noise["eps"]``
[B, latent_dim] is the draw's standard normal."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..config import EnvConfig, VAEConfig
from ..utils.viz import for_viz
from .common import (Conv2dBlock, conv2d, conv_nhwc, dense, given_or_drawn, img_to_slot,
                     pixel_shuffle)


def _stages(compression_rate: int) -> int:
    stages = math.log2(compression_rate)
    if not stages.is_integer():
        raise ValueError(f"compression rate {compression_rate} is not a power of two")
    return int(stages)


class VAEEncoder(nn.Module):
    def __init__(self, in_channels: int, out_dim: int, compression_rate: int):
        super().__init__()
        blocks = []
        for i in range(_stages(compression_rate)):
            blocks.append(Conv2dBlock(in_channels if i == 0 else 64, 64, 2, 2))
            blocks += [Conv2dBlock(64, 64, 1, 1) for _ in range(3)]
        self.blocks = nn.Sequential(*blocks)
        self.out = conv2d(64, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.out, self.blocks(x))


class VAEDecoder(nn.Module):
    """[B, s, s, 64] -> [B, H, W, obs_channels], NHWC
    (ocrl_tpu/models/vae.py:38-53)."""

    def __init__(self, obs_channels: int, compression_rate: int):
        super().__init__()
        blocks = [Conv2dBlock(64, 64, 1)]
        for _ in range(_stages(compression_rate)):
            blocks += [Conv2dBlock(64, 64, 3, 1, 1), Conv2dBlock(64, 64, 1, 1),
                       Conv2dBlock(64, 64, 1, 1), Conv2dBlock(64, 64 * 2 * 2, 1)]
        self.blocks = nn.ModuleList(blocks)
        self.out = conv2d(64, obs_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks[0](x)
        for i, block in enumerate(self.blocks[1:]):
            x = block(x)
            if i % 4 == 3:                       # the stage's last block: to twice the size
                x = pixel_shuffle(x, 2)
        return conv_nhwc(self.out, x)


class VAE_Module(nn.Module):
    def __init__(self, ocr_config: VAEConfig, env_config: EnvConfig, *,
                 decoder: bool = False):
        super().__init__()
        s = ocr_config.cnn_feat_size
        self.cnn_feat_size, self.kld_weight = s, ocr_config.learning.kld_weight
        self.use_cnn_feat = ocr_config.use_cnn_feat
        compression = env_config.obs_size // s
        self.enc = VAEEncoder(env_config.obs_channels, 64, compression)
        self.mu = dense(64 * s * s, ocr_config.latent_dim)
        self.var = dense(64 * s * s, ocr_config.latent_dim)
        if decoder:
            self.in_dec = dense(ocr_config.latent_dim, 64 * s * s)
            self.dec = VAEDecoder(env_config.obs_channels, compression)

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, H, W, C] in [0, 1] -> mu [B, latent_dim], or the
        encoder's map as slots [B, s*s, 64]; ``noise`` and ``generator`` are
        unused."""
        feat = self.enc(obs)
        if self.use_cnn_feat:
            return img_to_slot(feat)
        return self.mu(feat.reshape(feat.shape[0], -1))

    def _reconstruct(self, obs: torch.Tensor, generator, noise: dict | None):
        """(mu, log_var, the decoded draw [B, H, W, C])."""
        flat = self.enc(obs).reshape(obs.shape[0], -1)
        mu, log_var = self.mu(flat), self.var(flat)
        eps = given_or_drawn(noise, "eps", lambda: torch.randn(
            mu.shape, generator=generator, device=mu.device))
        latent = mu + eps * torch.exp(0.5 * log_var)
        s = self.cnn_feat_size
        return mu, log_var, self.dec(self.in_dec(latent).reshape(obs.shape[0], s, s, 64))

    def loss(self, obs: torch.Tensor, masks=None, step: int = 0, train: bool = False, *,
             generator: torch.Generator | None = None, noise: dict | None = None):
        """(loss, {"loss", "mse", "kld"}) of obs [B, H, W, C] in [0, 1]; the
        reported ``kld`` is minus the KL term (vae.py:97). ``masks``,
        ``step`` and ``train`` are unused."""
        mu, log_var, recon = self._reconstruct(obs, generator, noise)
        mse = ((obs - recon) ** 2).sum() / obs.shape[0]
        kld = (-0.5 * (1 + log_var - mu ** 2 - torch.exp(log_var)).sum(1)).mean()
        loss = mse + self.kld_weight * kld
        return loss, {"loss": loss, "mse": mse, "kld": -kld}

    @torch.no_grad()
    def sample_arrays(self, obs: torch.Tensor, generator: torch.Generator | None = None,
                      noise: dict | None = None):
        """(obs, the decoded draw) (vae.py:99-103)."""
        return obs, self._reconstruct(obs, generator, noise)[2]

    @staticmethod
    def samples_grid(obs, recon) -> dict:
        """obs above its reconstruction, uint8."""
        return {"samples": np.concatenate([for_viz(obs), for_viz(recon)], axis=-3)}


def dims(ocr_config: VAEConfig, env_config: EnvConfig) -> tuple[int, int]:
    if ocr_config.use_cnn_feat:
        return 64, ocr_config.cnn_feat_size ** 2
    return ocr_config.latent_dim, 1
