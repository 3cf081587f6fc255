"""Read checkpoint files written by the JAX package, without flax or msgpack
(counterpart of the read side of ocrl_tpu/utils/checkpoint.py).

A file is ``OCRLTPU1``, the length of a JSON metadata block as a little-
endian u64, the JSON, then the tree as flax's msgpack payload
(ocrl_tpu/utils/checkpoint.py:23-37). ``load_checkpoint`` decodes the subset
of msgpack that flax writes for a model's tree: maps, arrays, str, bin,
ints, floats, nil and bool, and flax's extension types 1 (an ndarray, whose
payload is itself msgpack ``[shape, dtype name, buffer]``) and 3 (a numpy
scalar, the same payload). It returns what
``flax.serialization.msgpack_restore`` returns: nested dicts (flax keeps
tuples and lists as maps keyed "0", "1", ...) of numpy arrays and Python
scalars. (flax cuts an array above 2^30 bytes into chunks; no model of the
repo holds one, and such a leaf comes back as flax's chunk map.)

``get_ocr`` builds the port's OCR from its configs and, when a checkpoint is
configured, loads the JAX OCR's parameters from it
(ocrl_tpu/poolings/wrapper.py:49-63): ``ocr_module_state_dict`` through
``convert.ocr_from_flax``, keeping the fresh module's values for parameters
the payload lacks. The optimizer state is not carried across.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ..models import create_ocr
from .convert import ocr_from_flax

_MAGIC = b"OCRLTPU1"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# (format byte, struct code of the big-endian length or value)
_SIZED = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",                 # bin
          0xd9: ">B", 0xda: ">H", 0xdb: ">I",                 # str
          0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",     # array, map
          0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}                 # ext
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack payload ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, code: str):
        return struct.unpack(code, self.take(struct.calcsize(code)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            kind = self.unpack(">b")
            return _extension(kind, bytes(self.take(_FIXEXT[b])))
        if b in _SIZED:
            n = self.unpack(_SIZED[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b <= 0xc9:
                kind = self.unpack(">b")
                return _extension(kind, bytes(self.take(n)))
            if b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b <= 0xdd:
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack format byte 0x{b:02x} is not one flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _extension(kind: int, payload: bytes):
    if kind in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype, buffer = unpackb(payload)
        array = np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)
        return array if kind == _EXT_NDARRAY else array[()]
    raise ValueError(f"msgpack extension type {kind} is not one flax writes")


def unpackb(data: bytes):
    """Decode one msgpack value that fills ``data``."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return value


def load_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """(tree, metadata) of an ``OCRLTPU1`` file."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"not an ocrl_tpu checkpoint: {path}")
        (meta_len,) = struct.unpack("<Q", f.read(8))
        metadata = json.loads(f.read(meta_len).decode())
        payload = f.read()
    return unpackb(payload), metadata


def migrate_bcdec_tree(d):
    """Rename broadcast-decoder state saved under the older
    ``blocks/layers_{0..3}`` layout to the ``conv1`` / ``rest`` layout
    (ocrl_tpu/utils/checkpoint.py:40-63), recursively, so that optimizer
    mirrors of the tree move too."""
    if not isinstance(d, dict):
        return d
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k == "bcdec" and "blocks" in v \
                and "layers_0" in v["blocks"]:
            b = v["blocks"]
            nv = {kk: migrate_bcdec_tree(vv) for kk, vv in v.items() if kk != "blocks"}
            nv["conv1"] = b["layers_0"]["Conv_0"]
            nv["rest"] = {"layers_0": b["layers_1"], "layers_1": b["layers_2"],
                          "layers_2": b["layers_3"]}
            out[k] = nv
        else:
            out[k] = migrate_bcdec_tree(v)
    return out


def resolve_ocr_checkpoint_path(cpt_config) -> Path | None:
    """``local_file``, else the best or latest checkpoint of the local run
    directory ``run_id``, else None (ocrl_tpu/poolings/wrapper.py:26-46)."""
    if cpt_config.local_file:
        path = Path(cpt_config.local_file)
        if not path.exists():
            raise FileNotFoundError(f"OCR checkpoint not found: {path}")
        return path
    if cpt_config.run_id:
        for name in ("model_best.ckpt", "model_latest.ckpt"):
            path = Path(cpt_config.run_id) / "checkpoints" / name
            if path.exists():
                return path
        raise FileNotFoundError(f"no checkpoint under the run directory "
                                f"'{cpt_config.run_id}'")
    return None


def get_ocr(ocr_config, env_config, cpt_config, seed: int = 0, device=None):
    """(OCR, pretrained): the OCR of the configs, with the weights of the
    configured checkpoint when there is one."""
    ocr = create_ocr(ocr_config, env_config, seed, device)
    path = resolve_ocr_checkpoint_path(cpt_config)
    if path is None:
        return ocr, False
    tree, _ = load_checkpoint(path)
    state = ocr.module.state_dict()     # what the payload lacks keeps its value
    state.update(ocr_from_flax(migrate_bcdec_tree(tree)["ocr_module_state_dict"]))
    ocr.module.load_state_dict(state)
    return ocr, True
