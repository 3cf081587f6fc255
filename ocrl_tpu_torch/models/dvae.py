"""Discrete VAE, CNN encoder and spatial-broadcast decoder of SLATE /
Slot-Attention (counterpart of ocrl_tpu/models/dvae.py)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import gumbel
from .common import (Conv2dBlock, PositionalEmbedding, conv2d, conv_nhwc, gumbel_draw,
                     gumbel_field_rows, gumbel_softmax, pixel_shuffle)

_SHUFFLE_AFTER = (4, 8)   # decoder blocks followed by pixel_shuffle(2)


class dVAE(nn.Module):
    """Gumbel-softmax discrete VAE over a 4x-downsampled token grid
    (ocrl_tpu/models/dvae.py:15-76). NHWC in and out.

    Encoder: a 4x4 stride-4 conv block, six 1x1 conv blocks, a 1x1 conv to
    the vocabulary. Decoder: nine conv blocks, ``pixel_shuffle(2)`` after
    blocks 4 and 8, then a 1x1 conv to the image channels."""

    def __init__(self, vocab_size: int, img_channels: int, hidden: int = 64):
        super().__init__()
        self.encoder = nn.Sequential(
            Conv2dBlock(img_channels, hidden, 4, 4),
            *(Conv2dBlock(hidden, hidden, 1, 1) for _ in range(6)),
            conv2d(hidden, vocab_size, 1),
        )
        shuffled = hidden * 2 * 2
        self.decoder_blocks = nn.ModuleList([
            Conv2dBlock(vocab_size, hidden, 1),
            Conv2dBlock(hidden, hidden, 3, 1, 1), Conv2dBlock(hidden, hidden, 1, 1),
            Conv2dBlock(hidden, hidden, 1, 1), Conv2dBlock(hidden, shuffled, 1),
            Conv2dBlock(hidden, hidden, 3, 1, 1), Conv2dBlock(hidden, hidden, 1, 1),
            Conv2dBlock(hidden, hidden, 1, 1), Conv2dBlock(hidden, shuffled, 1),
        ])
        self.decoder_out = conv2d(hidden, img_channels, 1)

    def encode_logits(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in self.encoder:
            x = layer(x) if isinstance(layer, Conv2dBlock) else conv_nhwc(layer, x)
        return x

    def sample(self, flat_logits: torch.Tensor, tau: float, hard: bool,
               generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None,
               g_out: torch.Tensor | None = None) -> torch.Tensor:
        """Gumbel sample of logits [R, vocab]. ``hard=False`` is kernel B1
        (``ops.gumbel``); ``hard=True`` the straight-through one-hot on the
        plain noise path. ``noise`` is the Gumbel field to use instead of a
        draw from ``generator``; ``g_out`` receives the field used. Under a
        data-parallel shard the rows are the rank's rows of the global
        batch's field (``models.common.gumbel_draw``)."""
        noise, row0 = gumbel_draw(flat_logits, generator, noise)
        if not hard:
            return gumbel.gumbel_softmax_sample(flat_logits, tau, generator=generator,
                                                noise=noise, g_out=g_out, row0=row0)
        if noise is None:
            noise = gumbel_field_rows(flat_logits, generator)
        if g_out is not None:
            g_out.copy_(noise)
        return gumbel_softmax(flat_logits, noise, tau, True)

    def forward(self, obs: torch.Tensor, tau: float = 1.0, hard: bool = True,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None,
                g_out: torch.Tensor | None = None):
        """obs [B, H, W, C] -> (z [B, h, w, vocab], z_logits); see ``sample``."""
        z_logits = self.encode_logits(obs)
        B, H, W, V = z_logits.shape
        z = self.sample(z_logits.reshape(-1, V).contiguous(), tau, hard, generator,
                        noise, g_out)
        return z.reshape(B, H, W, V), z_logits

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for i, block in enumerate(self.decoder_blocks):
            x = block(x)
            if i in _SHUFFLE_AFTER:
                x = pixel_shuffle(x, 2)
        return conv_nhwc(self.decoder_out, x)


class SlotAttnCNNEncoder(nn.Module):
    """Full-resolution CNN feature extractor: three 5x5 conv+ReLU blocks and
    a 5x5 conv, stride 1, padding 2. NHWC in and out."""

    def __init__(self, hidden_size: int, in_channels: int = 3):
        super().__init__()
        self.blocks = nn.Sequential(
            Conv2dBlock(in_channels, hidden_size, 5, 1, 2),
            Conv2dBlock(hidden_size, hidden_size, 5, 1, 2),
            Conv2dBlock(hidden_size, hidden_size, 5, 1, 2),
        )
        self.out = conv2d(hidden_size, hidden_size, 5, 1, 2)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.out, self.blocks(obs))


class BroadCastDecoder(nn.Module):
    """Spatial-broadcast decoder (ocrl_tpu/models/dvae.py:94-151): each slot
    is broadcast over the image, positions are added, three conv layers and
    a 3x3 conv give RGB and a mask logit per slot, and the slots' images
    are composited with the softmax of their masks over the slots. NHWC.

    The first conv is evaluated as the JAX module restructures it, with the
    same math: its input ``broadcast(slot) + pos`` is linear in both terms,
    so ``conv1(broadcast(s) + pos) = conv1(broadcast(s)) + conv1(pos) - b``,
    and the slot term, constant over the image but for the zero padding, is
    taken on a 5x5 grid (which holds every border pattern of a 5x5 conv
    with padding 2) and tiled back to H x W."""

    def __init__(self, obs_size: int, obs_channels: int, hidden_size: int,
                 slot_size: int):
        super().__init__()
        self.obs_size = obs_size
        self.obs_channels = obs_channels
        self.conv1 = conv2d(slot_size, hidden_size, 5, 1, 2, weight_init="kaiming")
        self.rest = nn.Sequential(
            Conv2dBlock(hidden_size, hidden_size, 5, 1, 2),
            Conv2dBlock(hidden_size, hidden_size, 5, 1, 2),
            conv2d(hidden_size, obs_channels + 1, 3, 1, 1),
        )
        self.pos_emb = PositionalEmbedding(obs_size, slot_size)
        H, k = obs_size, 5 // 2
        border = torch.cat([torch.arange(k), torch.full((H - 2 * k,), k),
                            torch.arange(k + 1, 2 * k + 1)])
        self.register_buffer("border", border, persistent=False)

    def forward(self, slots: torch.Tensor) -> torch.Tensor:
        """slots [B, N, D] -> the composited image [B, H, W, C]."""
        B, N, D = slots.shape
        H = W = self.obs_size
        proj = self.pos_emb(slots.new_zeros(1, H, W, D))           # [1, H, W, D]
        small = conv_nhwc(self.conv1, slots.reshape(B * N, 1, 1, D).expand(B * N, 5, 5, D))
        slot_part = small[:, self.border][:, :, self.border]       # [B*N, H, W, hidden]
        x = torch.relu(slot_part + conv_nhwc(self.conv1, proj) - self.conv1.bias)
        for layer in self.rest:
            x = layer(x) if isinstance(layer, Conv2dBlock) else conv_nhwc(layer, x)
        C = self.obs_channels
        img_slots = x[..., :C].reshape(B, N, H, W, C)
        masks = torch.softmax(x[..., C:].reshape(B, N, H, W, 1), dim=1)
        return (img_slots * masks).sum(1)
