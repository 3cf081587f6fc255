"""Anti-aliased 2D sprite renderer (counterpart of the native path of
ocrl_tpu/envs/renderer.py:102-123): sprites with (x, y, shape, scale, rgb)
drawn as polygons onto a square canvas at ``anti_aliasing`` x
supersampling, y-axis pointing up, by the port's C++ rasterizer
(``ocrl_tpu_torch.native``) over black.

The JAX package's PIL path and background images are left out: no env
config sets ``background.use_bg``. Asking for a background raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .. import native

SHAPES = [
    "square", "triangle", "star_4", "circle", "pentagon", "hexagon",
    "octagon", "star_5", "star_6", "spoke_4", "spoke_5", "spoke_6",
]
LATER = "the slice that ports background images"


@dataclass
class Sprite:
    x: float
    y: float
    shape: str
    scale: float
    rgb: tuple[int, int, int]


def _regular_polygon(n: int, phase: float = 0.0) -> np.ndarray:
    angles = 2 * math.pi * np.arange(n) / n + phase
    return np.stack([np.cos(angles), np.sin(angles)], axis=1)


def _star(n: int, inner: float = 0.5, phase: float = math.pi / 2) -> np.ndarray:
    angles = math.pi * np.arange(2 * n) / n + phase
    radii = np.where(np.arange(2 * n) % 2 == 0, 1.0, inner)
    return np.stack([radii * np.cos(angles), radii * np.sin(angles)], axis=1)


def shape_vertices(shape: str) -> np.ndarray:
    """Unit-circumradius vertex list for a named shape, centred at origin."""
    if shape == "square":
        return _regular_polygon(4, phase=math.pi / 4)
    if shape == "triangle":
        return _regular_polygon(3, phase=math.pi / 2)
    if shape == "circle":
        return _regular_polygon(40)
    if shape == "pentagon":
        return _regular_polygon(5, phase=math.pi / 2)
    if shape == "hexagon":
        return _regular_polygon(6)
    if shape == "octagon":
        return _regular_polygon(8, phase=math.pi / 8)
    if shape.startswith("star_"):
        return _star(int(shape.split("_")[1]), inner=0.5)
    if shape.startswith("spoke_"):
        return _star(int(shape.split("_")[1]), inner=0.18)
    raise ValueError(f"Unknown shape '{shape}' (choose from {SHAPES})")


_VERTEX_CACHE: dict[str, np.ndarray] = {}


class SpriteRenderer:
    def __init__(self, image_size: tuple[int, int] = (64, 64), anti_aliasing: int = 10):
        self._size = image_size
        self._aa = anti_aliasing

    def set_background(self, img) -> None:
        raise NotImplementedError(f"background images come with {LATER}")

    def render(self, sprites: Sequence[Sprite]) -> np.ndarray:
        W, H = self._size
        ss_w, ss_h = W * self._aa, H * self._aa
        polys, colors = [], []
        for sprite in sprites:
            verts = _VERTEX_CACHE.get(sprite.shape)
            if verts is None:
                verts = shape_vertices(sprite.shape)
                _VERTEX_CACHE[sprite.shape] = verts
            # circumradius scale/2: the footprint matches the envs' collision radius
            r = sprite.scale / 2.0
            xs = (sprite.x + r * verts[:, 0]) * ss_w
            ys = (1.0 - (sprite.y + r * verts[:, 1])) * ss_h    # y-axis up
            polys.append(np.stack([xs, ys], axis=1))
            colors.append(sprite.rgb)
        colors = np.asarray(colors, np.uint8).reshape(-1, 3)
        return native.render_polygons(W, H, self._aa, polys, colors)
