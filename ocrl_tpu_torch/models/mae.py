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
``decoder=True`` it also holds the decoder (8 blocks of 512 at ``base``)
and takes the pretraining ``loss`` (mae.py:111-196): each image keeps a
random ``1 - masking_ratio`` of its patches (the first of
``argsort(noise)``), the encoder runs over those and the CLS, the decoder
over them, a ``mask_token`` for each patch dropped and the CLS, put back
in the image's order; the loss is the mean squared error on raw pixels of
the dropped patches. ``noise["masking"]`` [B, N] is the uniform draw the
order comes from. ``make_optimizer`` is its AdamW with the no-decay mask
(mae.py:212-228)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import EnvConfig, MAEConfig
from ..utils.viz import for_viz
from .base import MultiGroupAdam, constant
from .common import FLAX_LN_EPS, MultiHeadDotProductAttention, dense, given_or_drawn

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
        self.masking_ratio = ocr_config.masking_ratio
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
            self.register_buffer("dec_pos", torch.from_numpy(sincos_pos_embed_2d(dec_dim, g)),
                                 persistent=False)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, N, p*p*C]."""
        B, _, _, C = imgs.shape
        p, g = self.patch, self.grid
        x = imgs.reshape(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, g * g, p * p * C)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, p*p*C] -> [B, H, W, C]."""
        B, _, D = x.shape
        p, g = self.patch, self.grid
        x = x.reshape(B, g, g, p, p, D // (p * p)).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, g * p, g * p, D // (p * p))

    def _random_masking(self, x: torch.Tensor, noise: torch.Tensor):
        """(the kept tokens [B, len_keep, dim], the mask [B, N] with 1 where a
        patch is dropped, ids_restore [B, N]) (mae.py:111-124); the argsorts
        are stable, as jnp.argsort is."""
        B, N, D = x.shape
        len_keep = int(N * (1 - self.masking_ratio))
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x_masked = torch.gather(x, 1, ids_keep[..., None].expand(B, len_keep, D))
        mask = torch.ones(B, N, device=x.device)
        mask[:, :len_keep] = 0.0
        return x_masked, torch.gather(mask, 1, ids_restore), ids_restore

    def _encode(self, imgs: torch.Tensor, noise: torch.Tensor | None = None):
        """(the encoder's output [B, 1 + kept, dim], the mask, ids_restore)
        over the patches ``noise`` keeps, or over all of them (mask and
        ids_restore None) without it."""
        x = self.patch_embed(self.patchify(imgs)) + self.pos[None, 1:]
        mask = ids_restore = None
        if noise is not None:
            x, mask, ids_restore = self._random_masking(x, noise)
        cls = (self.cls_token + self.pos[None, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.encoder_norm(x), mask, ids_restore

    def encode_full_patches(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, 1 + N, dim]: the CLS and every patch."""
        return self._encode(imgs)[0]

    def _decode(self, latent: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """The encoder's output and ids_restore -> each patch's pixels
        [B, N, p*p*C] (mae.py:140-152)."""
        x = self.decoder_embed(latent)
        B, _, D = x.shape
        N = ids_restore.shape[1]
        x_ = torch.cat([x[:, 1:], self.mask_token.expand(B, N + 1 - x.shape[1], D)], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(B, N, D))     # unshuffle
        x = torch.cat([x[:, :1], x_], dim=1) + self.dec_pos[None]
        for block in self.decoder_blocks:
            x = block(x)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]

    def _masked_prediction(self, obs: torch.Tensor, generator, noise: dict | None):
        """(the predicted patches, the mask): with ``masking_ratio`` 0 every
        patch is kept and the mask is all zeros (mae.py:128-133)."""
        B, N = obs.shape[0], self.grid ** 2
        if self.masking_ratio > 0:
            order = given_or_drawn(noise, "masking", lambda: torch.rand(
                (B, N), generator=generator, device=obs.device))
            latent, mask, ids_restore = self._encode(obs, order)
        else:
            latent = self._encode(obs)[0]
            mask = torch.zeros(B, N, device=obs.device)
            ids_restore = torch.arange(N, device=obs.device).expand(B, N)
        return self._decode(latent, ids_restore), mask

    def forward(self, obs: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """obs [B, H, W, C] in [0, 1] -> [B, dim] (``return_cls``) or
        [B, N, dim]; ``noise`` and ``generator`` are unused (no masking)."""
        rep = self.encode_full_patches(obs)
        return rep[:, 0] if self.return_cls else rep[:, 1:]

    def loss(self, obs: torch.Tensor, masks=None, step: int = 0, train: bool = False, *,
             generator: torch.Generator | None = None, noise: dict | None = None):
        """(loss, {"loss", "mse"}, both the masked patches' mean squared
        error) of obs [B, H, W, C] in [0, 1]; ``masks``, ``step`` and
        ``train`` are unused."""
        pred, mask = self._masked_prediction(obs, generator, noise)
        per_patch = ((pred - self.patchify(obs)) ** 2).mean(-1)
        loss = (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {"loss": loss, "mse": loss}

    @torch.no_grad()
    def sample_arrays(self, obs: torch.Tensor, generator: torch.Generator | None = None,
                      noise: dict | None = None):
        """(obs, obs with its dropped patches blacked out, the same with the
        predictions pasted in) (mae.py:182-191)."""
        pred, mask = self._masked_prediction(obs, generator, noise)
        mask_img = self.unpatchify(mask[..., None].expand(-1, -1, self.patch ** 2 * 3))
        im_masked = obs * (1 - mask_img)
        return obs, im_masked, im_masked + self.unpatchify(pred) * mask_img

    @staticmethod
    def samples_grid(obs, im_masked, im_paste) -> dict:
        """The three images one above the other, uint8."""
        return {"samples": np.concatenate(
            [for_viz(obs), for_viz(im_masked), for_viz(im_paste)], axis=-3)}


def make_optimizer(module: MAE_Module, ocr_config: MAEConfig) -> MultiGroupAdam:
    """optax.adamw(lr, b1 0.9, b2 0.95, weight_decay) with the no-decay
    mask (mae.py:212-228). JAX decays each leaf not named ``bias`` or
    ``scale`` with ndim > 1. Every bias and LayerNorm weight of the port is
    1-D, and its 2-D and 3-D parameters are JAX's decayed leaves (kernels,
    ``cls_token``, ``mask_token``), so the rule here is the parameter's
    ndim: a name rule would decay the LayerNorm weights, which JAX calls
    ``scale``."""
    lr = ocr_config.learning
    params = list(module.parameters())
    return MultiGroupAdam(
        {"decay": ([p for p in params if p.dim() > 1], constant(lr.lr), lr.weight_decay),
         "no_decay": ([p for p in params if p.dim() <= 1], constant(lr.lr), 0.0)},
        betas=(0.9, 0.95))


def dims(ocr_config: MAEConfig, env_config: EnvConfig) -> tuple[int, int]:
    rep_dim = VIT_SIZES[ocr_config.vit_size]["dim"]
    if ocr_config.return_cls:
        return rep_dim, 1
    return rep_dim, (env_config.obs_size // ocr_config.patch_size) ** 2
