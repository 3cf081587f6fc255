"""Animated GIF files from numpy frames (the port has neither PIL nor
imageio; JAX's VideoRecorder writes with ``imageio.mimsave(..., fps=15)``).

``encode(frames)`` writes GIF89a: the header and logical screen, one global
palette, a NETSCAPE2.0 block that loops forever, then per frame a graphic
control block with a delay of 7 hundredths of a second (about 1/15 s) and
an image whose palette indices are LZW-coded (variable code width from the
palette's bits + 1 up to 12, a clear code first and whenever the table is
full, an end code last) in sub-blocks of at most 255 bytes.

Colours: the palette is every distinct colour of all the frames, in
ascending order of their packed RGB value, when there are at most 256 of
them; the frames are then written losslessly. With more (the rasterizer's
supersampled edges can give that), the palette is the 256 colours that
occur most often over all the frames (ties to the smaller packed RGB
value), and every pixel becomes the palette colour nearest to it in squared
RGB distance (ties to the lower palette index): a colour of the palette
stays exact, and no pixel moves further than to the nearest of the 256
most frequent colours. ``quantize`` gives that palette and those indices.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

DELAY = 7                  # hundredths of a second a frame: about 1/15 s
MAX_COLOURS = 256
_MAX_CODE = 4096           # LZW codes are at most 12 bits


def _packed(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, H, W] packed 0xRRGGBB as int64."""
    f = frames.astype(np.int64)
    return (f[..., 0] << 16) | (f[..., 1] << 8) | f[..., 2]


def quantize(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(palette [P, 3] uint8 with P <= 256, indices [T, H, W] uint8) by the
    rule of the module docstring."""
    packed = _packed(frames)
    colours, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(packed.shape)
    if colours.size <= MAX_COLOURS:
        palette = colours
        index_of = np.arange(colours.size)
    else:
        order = np.lexsort((colours, -counts))[:MAX_COLOURS]
        palette = colours[order]
        rgb = _rgb(colours).astype(np.int64)
        pal = _rgb(palette).astype(np.int64)
        dist = ((rgb[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
        index_of = dist.argmin(1)                 # the first of equal distances
    return _rgb(palette), index_of[inverse].astype(np.uint8)


def _rgb(packed: np.ndarray) -> np.ndarray:
    return np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255],
                    axis=-1).astype(np.uint8)


def _lzw(indices: np.ndarray, min_size: int) -> bytes:
    """The GIF LZW code stream of ``indices`` (uint8 below 2^min_size)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = bits = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, bits
        acc |= code << bits
        bits += width
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8

    def width(next_code: int) -> int:
        # the decoder holds one entry fewer than the encoder when it reads
        # a code, and widens once its next free code reaches 2^width
        return min(12, max(min_size + 1, (next_code - 1).bit_length()))

    table: dict[int, int] = {}
    next_code = end + 1
    emit(clear, min_size + 1)
    data = indices.tobytes()
    prefix = data[0]
    for c in data[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width(next_code))
        if next_code < _MAX_CODE:
            table[key] = next_code
            next_code += 1
        else:
            emit(clear, width(next_code))
            table.clear()
            next_code = end + 1
        prefix = c
    emit(prefix, width(next_code))
    emit(end, width(next_code + 1))
    if bits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode(frames) -> bytes:
    """The GIF bytes of uint8 RGB frames [T, H, W, 3] (a list of [H, W, 3])."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"GIF frames are uint8 [T, H, W, 3], not {frames.dtype} "
                         f"{frames.shape}")
    T, H, W, _ = frames.shape
    if not (T > 0 and 0 < H < 1 << 16 and 0 < W < 1 << 16):
        raise ValueError(f"cannot write {T} frames of {H} x {W}")
    palette, indices = quantize(frames)
    bits = max(1, (len(palette) - 1).bit_length())      # 2^bits table entries
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", W, H, 0x80 | 0x70 | (bits - 1), 0, 0)
    out += table.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    min_size = max(2, bits)
    for t in range(T):
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", DELAY) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0)
        out += bytes([min_size]) + _sub_blocks(_lzw(indices[t], min_size))
    out += b"\x3b"
    return bytes(out)


def write(path: str | Path, frames) -> None:
    Path(path).write_bytes(encode(frames))
