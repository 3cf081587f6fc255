"""Sample-grid helpers on the host, numpy only (the port's copy of
ocrl_tpu/utils/viz.py:12-33); images are NHWC."""

from __future__ import annotations

import numpy as np


def for_viz(x) -> np.ndarray:
    """[B, H, W, C] floats in [0, 1] -> uint8, clipped."""
    x = np.asarray(x)
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def visualize(images) -> np.ndarray:
    """The entries side by side along the width; each is [B, H, W, C] or
    [B, K, H, W, C], whose K images go in turn."""
    cols = []
    for img in images:
        img = np.asarray(img)
        if img.ndim == 4:
            cols.append(img)
        else:
            cols.extend(np.moveaxis(img, 1, 0))
    return np.concatenate(cols, axis=-2)
