"""The port's host C++, bound with ctypes: the sprite envs' rasterizer
(``rasterizer.cpp``) and the HDF5 reader's checksums and LZF decoder
(``hdf5_filters.cpp``).

At first use a source is compiled by ``g++`` (``$CXX`` when set) into
``build/ocrl_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout,
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
FILTERS_SOURCE = SOURCE.with_name("hdf5_filters.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ocrl_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_filters: ctypes.CDLL | None = None


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (the rasterizer by default) unless it is built;
    its library's path."""
    out = library_path(source)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler: {source.name} needs g++ (or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n{proc.stdout}{proc.stderr}")
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


def filters() -> ctypes.CDLL:
    """The loaded HDF5 filter library, built at first use."""
    global _filters
    if _filters is None:
        lib = ctypes.CDLL(str(build(FILTERS_SOURCE)))
        lib.hdf5_lookup3.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
        lib.hdf5_lookup3.restype = ctypes.c_uint32
        lib.hdf5_fletcher32.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.hdf5_fletcher32.restype = ctypes.c_uint32
        lib.hdf5_lzf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                            ctypes.c_size_t]
        lib.hdf5_lzf_decompress.restype = ctypes.c_int64
        _filters = lib
    return _filters


def lookup3(data: bytes) -> int:
    """Jenkins' lookup3 ``hashlittle`` of ``data`` from 0: HDF5's metadata
    checksum."""
    return filters().hdf5_lookup3(data, len(data), 0)


def fletcher32(data: bytes) -> int:
    """HDF5's fletcher32 checksum of ``data``."""
    return filters().hdf5_fletcher32(data, len(data))


def lzf_decompress(data: bytes, size: int) -> bytes:
    """``data`` decoded by LZF into exactly ``size`` bytes; a stream that is
    corrupt or decodes to another size raises ValueError."""
    out = bytearray(size)
    n = filters().hdf5_lzf_decompress(data, len(data), (ctypes.c_char * size).from_buffer(out),
                                      size)
    if n != size:
        raise ValueError(f"an LZF stream of {len(data)} bytes decoded to "
                         f"{'an error' if n < 0 else f'{n} bytes'}, not {size}")
    return bytes(out)


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
