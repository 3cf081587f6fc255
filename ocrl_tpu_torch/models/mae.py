"""The Masked Autoencoder's ViT encoder (counterpart of ocrl_tpu/models/mae.py).

What the RL path runs is ``encode_full_patches`` (mae.py:164-174): the image
cut into patches (``patchify``: row-major patches, each flattened as
p_h, p_w, C), a Dense to the ViT width, the fixed 2-D sin-cos position
embedding, a CLS token in front, pre-LN blocks (LayerNorm eps 1e-6, flax's
MultiHeadDotProductAttention, a 4x MLP with flax's tanh-approximated GELU)
and a final LayerNorm. The representation is the CLS output
(``return_cls``) or the patch outputs. ``VIT_SIZES`` holds the widths
(``base`` 768 wide, 12 blocks, 12 heads; ``tiny`` for tests).

The policy's module holds what JAX's policy tree holds: the encoder and
the ``mask_token`` (a parameter of the module itself). With
``decoder=True`` it also holds the decoder's parameters, so that a
checkpoint loads; the decoder's forward, the random masking and the loss
come with the slice that ports train_ocr for MAE."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import EnvConfig, MAEConfig
from .base import PRETRAINING
from .common import FLAX_LN_EPS, MultiHeadDotProductAttention, dense

VIT_SIZES = {
    "base": dict(dim=768, depth=12, heads=12, dec_dim=512, dec_depth=8, dec_heads=16),
    "large": dict(dim=1024, depth=24, heads=16, dec_dim=512, dec_depth=8, dec_heads=16),
    "tiny": dict(dim=32, depth=2, heads=2, dec_dim=16, dec_depth=1, dec_heads=2),
}


def sincos_pos_embed_2d(dim: int, grid_size: int, with_cls: bool = True) -> np.ndarray:
    """The fixed 2-D sin-cos position embedding, in float64 then float32
    (ocrl_tpu/models/mae.py:33-49): the first half of each row from the
    patch's column, the second from its row; a zero row for the CLS."""
    def embed_1d(pos, d):
        omega = np.arange(d // 2, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (d / 2))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(grid_size, dtype=np.float64),
                       np.arange(grid_size, dtype=np.float64))   # w goes first
    grid = np.stack(grid, axis=0).reshape(2, -1)
    emb = np.concatenate([embed_1d(grid[0], dim // 2), embed_1d(grid[1], dim // 2)], axis=1)
    if with_cls:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb.astype(np.float32)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.attn = MultiHeadDotProductAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.fc1 = dense(dim, int(dim * mlp_ratio))
        self.fc2 = dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))


class MAE_Module(nn.Module):
    def __init__(self, ocr_config: MAEConfig, env_config: EnvConfig, *,
                 decoder: bool = False):
        super().__init__()
        sizes = VIT_SIZES[ocr_config.vit_size]
        dim, dec_dim = sizes["dim"], sizes["dec_dim"]
        self.patch = p = ocr_config.patch_size
        self.grid = g = env_config.obs_size // p
        self.return_cls = ocr_config.return_cls
        C = env_config.obs_channels
        self.patch_embed = dense(p * p * C, dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim) * 0.02)
        self.blocks = nn.ModuleList(ViTBlock(dim, sizes["heads"]) for _ in range(sizes["depth"]))
        self.encoder_norm = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.mask_token = nn.Parameter(torch.randn(1, 1, dec_dim) * 0.02)
        self.register_buffer("pos", torch.from_numpy(sincos_pos_embed_2d(dim, g)),
                             persistent=False)
        if decoder:
            self.decoder_embed = dense(dim, dec_dim)
            self.decoder_blocks = nn.ModuleList(
                ViTBlock(dec_dim, sizes["dec_heads"]) for _ in range(sizes["dec_depth"]))
            self.decoder_norm = nn.LayerNorm(dec_dim, eps=FLAX_LN_EPS)
            self.decoder_pred = dense(dec_dim, p * p * C)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, N, p*p*C]."""
        B, _, _, C = imgs.shape
        p, g = self.patch, self.grid
        x = imgs.reshape(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, g * g, p * p * C)

    def encode_full_patches(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, 1 + N, dim]: the CLS and every patch."""
        x = self.patch_embed(self.patchify(imgs)) + self.pos[None, 1:]
        cls = (self.cls_token + self.pos[None, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.encoder_norm(x)

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, H, W, C] in [0, 1] -> [B, dim] (``return_cls``) or
        [B, N, dim]; ``noise`` and ``generator`` are unused (no masking)."""
        rep = self.encode_full_patches(obs)
        return rep[:, 0] if self.return_cls else rep[:, 1:]

    def loss(self, *args, **kwargs):
        raise NotImplementedError(f"MAE's loss comes with {PRETRAINING}")


def dims(ocr_config: MAEConfig, env_config: EnvConfig) -> tuple[int, int]:
    rep_dim = VIT_SIZES[ocr_config.vit_size]["dim"]
    if ocr_config.return_cls:
        return rep_dim, 1
    return rep_dim, (env_config.obs_size // ocr_config.patch_size) ** 2
