"""Scenes made from a seed: the benchmark's pretraining images.

Each scene is a random background with ``objects`` axis-aligned squares of
random colours, a quarter to a half of the image on a side, drawn in order
so that a later square covers an earlier one (the scenes of chip_smoke.py's
``painted``, drawn here for all scenes at once from numpy's
``default_rng(seed)``).
"""

from __future__ import annotations

import numpy as np


def painted(B: int, size: int, objects: int, seed: int) -> np.ndarray:
    """uint8 scenes [B, size, size, 3]."""
    rng = np.random.default_rng(seed)
    obs = np.empty((B, size, size, 3), np.uint8)
    obs[...] = rng.integers(0, 256, (B, 1, 1, 3), dtype=np.uint8)
    rows = np.arange(size)
    for _ in range(objects):
        h, w = rng.integers(size // 4, size // 2 + 1, (2, B))
        y = rng.integers(0, size - h + 1)
        x = rng.integers(0, size - w + 1)
        colour = rng.integers(0, 256, (B, 3), dtype=np.uint8)
        inside_y = (rows[None] >= y[:, None]) & (rows[None] < (y + h)[:, None])
        inside_x = (rows[None] >= x[:, None]) & (rows[None] < (x + w)[:, None])
        inside = inside_y[:, :, None] & inside_x[:, None, :]
        np.copyto(obs, colour[:, None, None, :], where=inside[..., None])
    return obs
