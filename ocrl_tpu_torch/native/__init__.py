"""The sprite envs' rasterizer: host C++ (``rasterizer.cpp``), bound with
ctypes.

At first use the source is compiled by ``g++`` (``$CXX`` when set) into
``build/ocrl_tpu_torch/librasterizer-<hash>.so`` at the root of the checkout,
keyed by a hash of the source and the flags, as ``ops/_build.py`` builds the
CUDA sources. The library is written under a temporary name and moved into
place, so processes that build at once (forked env workers) see all of it or
none. There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rasterizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ocrl_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librasterizer-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the rasterizer unless it is built; its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: the sprite envs' rasterizer needs g++ "
                           "(or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the rasterizer failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.render_polygons.argtypes = [
            ctypes.c_void_p,                           # out [H, W, 3] uint8
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # W, H, aa
            ctypes.c_void_p,                           # poly_xy float64
            ctypes.c_void_p,                           # poly_sizes int32
            ctypes.c_void_p,                           # colors [n, 3] uint8
            ctypes.c_int,                              # n_polys
            ctypes.c_void_p,                           # bg (null: black)
        ]
        lib.render_polygons.restype = None
        _lib = lib
    return _lib


def render_polygons(W: int, H: int, aa: int, polys: list[np.ndarray],
                    colors: np.ndarray) -> np.ndarray:
    """polys: [n_i, 2] float64 vertex arrays in supersampled pixel
    coordinates, painted in order over black; colors [n_polys, 3] uint8.
    Returns [H, W, 3] uint8."""
    lib = load()
    out = np.empty((H, W, 3), np.uint8)
    if polys:
        xy = np.ascontiguousarray(np.concatenate([p.reshape(-1, 2) for p in polys]),
                                  np.float64)
        sizes = np.asarray([len(p) for p in polys], np.int32)
    else:
        xy = np.zeros((1, 2), np.float64)
        sizes = np.zeros((0,), np.int32)
    colors = np.ascontiguousarray(colors, np.uint8)
    if colors.shape != (len(polys), 3) or (sizes < 3).any():
        raise ValueError(f"render_polygons: {len(polys)} polygons of at least 3 vertices "
                         f"need colors [{len(polys)}, 3], got {colors.shape}")
    lib.render_polygons(out.ctypes.data, W, H, aa, xy.ctypes.data, sizes.ctypes.data,
                        colors.ctypes.data, len(polys), None)
    return out
