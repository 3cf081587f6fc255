"""PNG files from numpy arrays with zlib alone (the port has no PIL):
8-bit greyscale [H, W] (or [H, W, 1]) and RGB [H, W, 3], each row with
filter 0, one IDAT chunk, a CRC32 per chunk. ``decode`` reads back what
``encode`` writes, checking each chunk's CRC."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}                 # channels -> PNG colour type (grey, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + \
        struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode(image: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 image [H, W], [H, W, 1] or [H, W, 3]."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"PNG images are uint8 here, not {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"an image of shape {image.shape} is neither grey nor RGB")
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + \
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b"")


def write(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(encode(image))


def decode(data: bytes) -> np.ndarray:
    """The image of PNG bytes as ``encode`` writes them (8-bit grey or RGB,
    filter 0 on every row); a bad signature, CRC or layout raises."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    at, chunks = 8, {}
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"the CRC of the {kind.decode()} chunk does not match")
        chunks[kind] = chunks.get(kind, b"") + body
        at += 12 + n
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace or b"IEND" not in chunks:
        raise ValueError(f"a PNG outside 8-bit grey or RGB (depth {depth}, colour {color})")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("a row with a PNG filter other than 0")
    image = rows[:, 1:].reshape(h, w, channels)
    return image[..., 0] if channels == 1 else image
