"""Shared building blocks (counterpart of ocrl_tpu/models/common.py).

Same math and initialisation rules as the JAX blocks. Public functions take
and return NHWC images, as the JAX package does; a convolution permutes to
NCHW and back as views (the NHWC tensor is NCHW in channels-last strides), so
no copy is made.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gumbel

# flax.linen.LayerNorm's default epsilon; torch's is 1e-5.
FLAX_LN_EPS = 1e-6


def _init_weight(weight: torch.Tensor, weight_init: str, gain: float = 1.0) -> None:
    if weight_init == "kaiming":
        # == variance_scaling(2, fan_in, uniform) in flax
        nn.init.kaiming_uniform_(weight, nonlinearity="relu")
    elif weight_init == "xavier":
        nn.init.xavier_uniform_(weight, gain)
    else:
        raise ValueError(f"unknown weight_init '{weight_init}'")


def linear(in_features: int, out_features: int, bias: bool = True,
           weight_init: str = "xavier", gain: float = 1.0) -> nn.Linear:
    """Init-controlled Linear (ocrl_tpu/models/common.py:28-33)."""
    m = nn.Linear(in_features, out_features, bias=bias)
    _init_weight(m.weight, weight_init, gain)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def conv2d(in_channels: int, out_channels: int, kernel_size: int,
           stride: int = 1, padding: int = 0, bias: bool = True,
           weight_init: str = "xavier") -> nn.Conv2d:
    """Init-controlled Conv2d (ocrl_tpu/models/common.py:36-49)."""
    m = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                  bias=bias)
    _init_weight(m.weight, weight_init)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default Dense and Conv init: truncated normal, variance
    1/fan_in (a Linear's in_features, a conv's in_channels * kh * kw)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def dense(in_features: int, out_features: int) -> nn.Linear:
    """flax nn.Dense with its default init: lecun-normal kernel, zero bias."""
    m = nn.Linear(in_features, out_features)
    lecun_normal_(m.weight)
    nn.init.zeros_(m.bias)
    return m


def flax_conv(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
              padding: int = 0, groups: int = 1) -> nn.Conv2d:
    """flax nn.Conv with its default init (lecun-normal kernel, zero bias);
    ``padding`` an int is flax's explicit symmetric padding, 0 its VALID."""
    m = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, groups=groups)
    lecun_normal_(m.weight)
    nn.init.zeros_(m.bias)
    return m


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Apply an NCHW convolution to an NHWC tensor, returning NHWC.

    ``dtype`` is flax's compute dtype (``promote_dtype``): the input, kernel
    and bias are cast to it, the convolution's output is rounded to it, and
    the bias is added in it, a second rounding, as XLA computes flax's
    ``nn.Conv(dtype=...)``. The parameters stay fp32: the casts' backward
    brings their gradients back to fp32. None computes in the parameters'
    dtype, the bias inside the convolution."""
    if dtype is None:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), None,
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1)


class Conv2dBlock(nn.Module):
    """conv (kaiming init) + ReLU (ocrl_tpu/models/common.py:52-65), NHWC,
    computed in ``dtype`` (``conv_nhwc``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, weight_init="kaiming")
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(conv_nhwc(self.conv, x, self.dtype))


class PositionalEmbedding(nn.Module):
    """Four linear position ramps -> 1x1 conv, added to NHWC features
    (ocrl_tpu/models/common.py:82-99)."""

    def __init__(self, obs_size: int, channels: int):
        super().__init__()
        H = W = obs_size
        east = torch.linspace(0, 1, W)[None, :].expand(H, W)
        west = torch.linspace(1, 0, W)[None, :].expand(H, W)
        south = torch.linspace(0, 1, H)[:, None].expand(H, W)
        north = torch.linspace(1, 0, H)[:, None].expand(H, W)
        grid = torch.stack([north, south, west, east], dim=0)[None]  # [1,4,H,W]
        self.register_buffer("grid", grid.contiguous(), persistent=False)
        self.channels_map = conv2d(4, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.channels_map(self.grid).permute(0, 2, 3, 1)


class FusedGRUCell(nn.Module):
    """torch-semantics GRU cell with r|z|n gate blocks
    (ocrl_tpu/models/common.py:149-174): ``wi`` and ``wh`` map to [3D]."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.features = features
        self.wi = nn.Linear(input_size, 3 * features)
        self.wh = nn.Linear(features, 3 * features)
        nn.init.xavier_uniform_(self.wi.weight)
        nn.init.orthogonal_(self.wh.weight)
        nn.init.zeros_(self.wi.bias)
        nn.init.zeros_(self.wh.bias)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        D = self.features
        zi = self.wi(x)
        zh = self.wh(h)
        r = torch.sigmoid(zi[..., :D] + zh[..., :D])
        z = torch.sigmoid(zi[..., D:2 * D] + zh[..., D:2 * D])
        n = torch.tanh(zi[..., 2 * D:] + r * zh[..., 2 * D:])
        return (1.0 - z) * n + z * h


def img_to_slot(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, D] -> [B, H*W, D], row-major over the image
    (ocrl_tpu/utils/viz.py:34-38)."""
    B, H, W, D = x.shape
    return x.reshape(B, H * W, D)


def slot_to_img(slot: torch.Tensor) -> torch.Tensor:
    """[B, N, D] -> [B, sqrt(N), sqrt(N), D] (ocrl_tpu/utils/viz.py:41-45)."""
    B, N, D = slot.shape
    size = int(round(N ** 0.5))
    return slot.reshape(B, size, size, D)


_MLP_ACTS = {"relu": torch.relu, "tanh": torch.tanh, "none": None, "linear": None, None: None}


class MLP(nn.ModuleList):
    """Dense layers with per-layer activations ("relu", "tanh", or none:
    "none", "linear", None), flax's default init
    (ocrl_tpu/models/common.py:177-196)."""

    def __init__(self, in_features: int, dims, acts):
        for act in acts:
            if act not in _MLP_ACTS:
                raise ValueError(f"activation '{act}' is not implemented")
        dims = (in_features,) + tuple(dims)
        super().__init__(dense(a, b) for a, b in zip(dims, dims[1:]))
        self.acts = tuple(acts)
        self.out_features = dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, act in zip(self, self.acts):
            x = layer(x)
            if _MLP_ACTS[act] is not None:
                x = _MLP_ACTS[act](x)
        return x


class MultiHeadDotProductAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention, self-attention, no dropout.
    ``query``/``key``/``value`` map to heads x head_dim, ``out`` back."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.query = dense(d_model, d_model)
        self.key = dense(d_model, d_model)
        self.value = dense(d_model, d_model)
        self.out = dense(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.query(x).view(B, L, H, hd) / math.sqrt(hd)
        k = self.key(x).view(B, L, H, hd)
        v = self.value(x).view(B, L, H, hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, D)
        return self.out(o)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W, C*f*f] -> [B, H*f, W*f, C] in the sub-pixel order of
    ocrl_tpu/models/common.py:68-79 (torch's PixelShuffle order, NHWC)."""
    B, H, W, C = x.shape
    f = factor
    x = x.reshape(B, H, W, C // (f * f), f, f)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(B, H * f, W * f, C // (f * f))


def cosine_anneal(step: int, start_value: float, final_value: float,
                  start_step: int, final_step: int) -> float:
    """ocrl_tpu/models/common.py:103-111, as a function of a Python step."""
    if step < start_step:
        return start_value
    if step >= final_step:
        return final_value
    a = 0.5 * (start_value - final_value)
    b = 0.5 * (start_value + final_value)
    progress = (step - start_step) / max(final_step - start_step, 1)
    return a * math.cos(math.pi * progress) + b


def linear_warmup(step: int, start_value: float, final_value: float,
                  start_step: int, final_step: int) -> float:
    """ocrl_tpu/models/common.py:114-121 (note the ``step + 1``)."""
    if step < start_step:
        return start_value
    if step >= final_step:
        return final_value
    progress = (step + 1 - start_step) / max(final_step - start_step, 1)
    return (final_value - start_value) * progress + start_value


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor, tau: float = 1.0,
                   hard: bool = False) -> torch.Tensor:
    """Gumbel-softmax over the last axis given the Gumbel field ``noise``,
    with the straight-through one-hot when ``hard``
    (ocrl_tpu/models/common.py:126-137)."""
    y_soft = torch.softmax((logits + noise) / tau, dim=-1)
    if not hard:
        return y_soft
    index = y_soft.argmax(-1, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(-1, index, 1.0)
    return y_hard - y_soft.detach() + y_soft


# The data-parallel shard (rank, world size) of each sharded OCR, keyed by
# the OCR's generator, which every draw of its module takes: parallel.shard_ocr
# sets it, and from then on every draw with a batch axis from that generator
# keeps the rank's rows of the draw one process makes for the whole batch, as
# JAX's sharded step draws at the global shape and each device keeps its
# rows. It holds wherever the module runs (the OCR's methods, or a caller of
# ``ocr.module`` that passes ``ocr.generator``, as poolings/wrapper.py does).
# Keyed by id and holding the generator itself, so that no other object can
# take its id (some torch versions refuse a weak reference to a Generator).
_SHARDS: dict[int, tuple[torch.Generator, tuple[int, int]]] = {}


def shard_draws(generator: torch.Generator, shard: tuple[int, int]) -> None:
    """Make ``generator``'s draws those of ``shard`` (rank, world size)."""
    _SHARDS[id(generator)] = (generator, shard)


def _shard_of(generator: torch.Generator | None) -> tuple[int, int] | None:
    held = None if generator is None else _SHARDS.get(id(generator))
    return None if held is None else held[1]


def drawn(shape, draw, generator: torch.Generator | None, batch_axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` in one process. Under ``generator``'s shard (rank r of
    W): ``draw`` at W times the rows on ``batch_axis``, the global batch's
    shape, and rows [r n, (r + 1) n) of it kept, so the generator advances
    as in one process and each rank holds its rows of the same draw."""
    shard = _shard_of(generator)
    if shard is None:
        return draw(tuple(shape))
    rank, world = shard
    n = shape[batch_axis]
    full = tuple(n * world if i == batch_axis else d for i, d in enumerate(shape))
    return draw(full).narrow(batch_axis, rank * n, n).contiguous()


def randn(shape, generator: torch.Generator | None, device, batch_axis: int = 0,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normals from ``generator``, the shard's rows (``drawn``)."""
    return drawn(shape, lambda s: torch.randn(s, generator=generator, device=device,
                                              dtype=dtype), generator, batch_axis)


def rand(shape, generator: torch.Generator | None, device, batch_axis: int = 0) -> torch.Tensor:
    """Uniforms in [0, 1) from ``generator``, the shard's rows (``drawn``)."""
    return drawn(shape, lambda s: torch.rand(s, generator=generator, device=device),
                 generator, batch_axis)


def gumbel_draw(logits: torch.Tensor, generator: torch.Generator | None,
                noise: torch.Tensor | None) -> tuple[torch.Tensor | None, int]:
    """How a Gumbel call site draws the field of ``logits`` [R, V]: (the
    field to pass as ``noise``, or None for the wrapper to draw it; the
    ``row0`` to pass). A given field is used as it is, and one process's
    wrapper draws its own. Under ``generator``'s shard (rank r) the rows
    are the rank's rows of the field one process draws for the whole
    batch: on the card the kernel draws them itself at row0 = r R; on the
    CPU they are drawn whole (``drawn``), since the plain twin of ``row0``
    advances the generator by a count that differs per rank."""
    shard = _shard_of(generator)
    if noise is not None or shard is None:
        return noise, 0
    if logits.device.type != "cpu":
        return None, shard[0] * logits.shape[0]
    return gumbel_field_rows(logits, generator), 0


def gumbel_field_rows(logits: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """A plain Gumbel field like ``logits`` from ``generator``, the shard's
    rows (``drawn``)."""
    return drawn(logits.shape, lambda s: gumbel.gumbel_field(s, generator, logits.device),
                 generator)


def given_or_drawn(noise: dict | None, key: str, draw) -> torch.Tensor:
    """``noise[key]`` where the dict holds it; else ``draw()``, stored into
    ``noise`` when there is one, so that a caller can replay it."""
    if noise is not None and key in noise:
        return noise[key]
    value = draw()
    if noise is not None:
        noise[key] = value
    return value


def keep_mask(shape, keep_prob: float, generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """Bernoulli(keep_prob) mask of a dropout, drawn from ``generator``
    (the shard's rows of the batch, axis 0)."""
    return rand(shape, generator, device) < keep_prob


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate and scale the kept
    values by 1 / (1 - rate); the identity unless training with rate > 0.
    Unlike F.dropout, the mask comes from an explicit generator."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    mask = keep_mask(x.shape, keep_prob, generator, x.device)
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
