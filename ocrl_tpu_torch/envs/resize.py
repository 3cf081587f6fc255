"""Pillow's ``Image.resize(size, Image.BILINEAR)`` of a uint8 H x W x C
image, bit for bit, in numpy (the card's machine has no PIL; the
CausalWorld wrappers resize with it, ocrl_tpu/envs/cw.py:200-202,276-278).

Pillow's resampler (``libImaging/Resample.c``) runs one pass per axis whose
size changes, the horizontal one first, each on 8-bit data:

- the triangle filter's support is widened by the scale when downscaling
  (``support = 1 * max(in / out, 1)``), and each output pixel takes the
  input pixels ``[int(center - support + 0.5), int(center + support +
  0.5))``, clipped to the image, weighted ``filter((x - center + 0.5) /
  filterscale)`` and normalised to sum 1, all in double;
- the weights become fixed point with 22 fraction bits, rounded half away
  from zero;
- an output is ``(2**21 + sum(pixel * weight)) >> 22``, clipped to 0..255,
  so the pass after the first reads rounded bytes.
"""

from __future__ import annotations

import functools

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=16)
def _coefficients(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] fixed-point weights of one pass
    (``precompute_coeffs`` then ``normalize_coeffs_8bpc``), read-only, as
    float64: every product of a byte and a weight and every sum of them is
    an integer below 2**31, so a float64 matrix product is exact."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    weights = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = [max(0.0, 1.0 - abs((x - center + 0.5) * ss)) for x in range(xmin, xmax)]
        total = sum(k)                   # left to right in double, as the C loop
        k = [w / total if total != 0.0 else w for w in k]
        weights[xx, xmin:xmax] = [int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0
                                  else int(0.5 + w * (1 << _PRECISION_BITS)) for w in k]
    weights = weights.T.astype(np.float64)
    weights.flags.writeable = False
    return weights


def _pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One pass along ``axis`` (0: rows, 1: columns) of uint8 [H, W, C]."""
    x = np.moveaxis(img, axis, -1).astype(np.float64)           # [..., in]
    acc = (1 << (_PRECISION_BITS - 1)) + (x @ weights).astype(np.int64)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C], as
    ``np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected uint8 [H, W, C], got {img.dtype} {img.shape}")
    if img.shape[1] != width:
        img = _pass(img, _coefficients(img.shape[1], width), 1)
    if img.shape[0] != height:
        img = _pass(img, _coefficients(img.shape[0], height), 0)
    return np.ascontiguousarray(img)
