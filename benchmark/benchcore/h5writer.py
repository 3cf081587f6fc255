"""A frozen copy of the HDF5 writer that OCRL's dataset files are made
with (the port's ``data/hdf5_format.create``, version 0 superblock, symbol
table groups, contiguous datasets, the layout h5py writes by default), so
that the benchmark's scenes reach the loader as a real dataset file and a
change to the program's writer cannot change what the benchmark reads.

``write(path, {group: {dataset: array}})`` lays the file out and fills each
dataset through a memory map.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _INTERNAL_K = 4, 16                # h5py's defaults: SNOD of 8, B-tree of 32
_ENTRY = 40                                 # a symbol table entry, 8-byte offsets
_SNOD_SIZE = 8 + 2 * _LEAF_K * _ENTRY
_BTREE_SIZE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
_HEAP_MIN = 88                              # h5py's first data segment of a group's heap
_DATASET_HEADER = 256                       # h5py's object header size for a dataset
_DATA_ALIGN = 64
_NIL, _DATASPACE, _DATATYPE, _FILL = 0x00, 0x01, 0x03, 0x05
_LAYOUT, _SYMBOL_TABLE = 0x08, 0x11


class UnsupportedHDF5(ValueError):
    """A dtype the writer does not write."""


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _message(kind: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", kind, len(data), flags) + data


def _object_header(messages: list[bytes], size: int | None = None) -> bytes:
    """A version-1 object header of ``messages``, filled to ``size`` bytes
    of messages with a NIL message as h5py leaves it."""
    body = b"".join(messages)
    count = len(messages)
    if size is not None and size > len(body):
        body += _message(_NIL, b"\0" * (size - len(body) - 8))
        count += 1
    return struct.pack("<BBHII4x", 1, 0, count, 1, len(body)) + body


def _datatype(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype.byteorder == ">" or (dtype.byteorder == "=" and np.little_endian is False):
        raise UnsupportedHDF5(f"a big-endian dtype {dtype}")
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return struct.pack("<B3sIHH", 0x10, bytes([0x08 if dtype.kind == "i" else 0, 0, 0]),
                           size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        exp_loc, exp_size, mant_size, bias = (23, 8, 23, 127) if size == 4 else \
            (52, 11, 52, 1023)
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([0x20, 8 * size - 1, 0]), size, 0,
                           8 * size, exp_loc, exp_size, 0, mant_size, bias)
    raise UnsupportedHDF5(f"dtype {dtype}: only integers and IEEE floats are written")


def _dataset_header(shape: tuple, dtype: np.dtype, address: int) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    space = struct.pack("<BBB5x", 1, len(shape), 1) + dims + dims
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    layout = struct.pack("<BBQQ", 3, 1, address, nbytes)
    messages = [_message(_DATASPACE, space, 1), _message(_DATATYPE, _datatype(dtype), 1),
                _message(_FILL, fill, 1), _message(_LAYOUT, layout)]
    return _object_header(messages, max(_DATASET_HEADER, sum(map(len, messages)) + 8))


def _heap(names: list[str], at: int) -> tuple[bytes, list[int]]:
    """A local heap at ``at`` holding ``names`` (offset 0 the empty name),
    with the free block h5py leaves after them; and each name's offset."""
    data, offsets = b"\0" * 8, []
    for name in names:
        offsets.append(len(data))
        raw = name.encode() + b"\0"
        data += raw + b"\0" * (_pad8(len(raw)) - len(raw))
    free, size = len(data), max(_HEAP_MIN, len(data) + 16)
    data += struct.pack("<QQ", 1, size - free) + b"\0" * (size - free - 16)
    return b"HEAP" + struct.pack("<B3xQQQ", 0, size, free, at + 32) + data, offsets


def _symbol_entry(name_offset: int, header: int, cached: tuple[int, int] | None) -> bytes:
    if cached is None:
        return struct.pack("<QQII16x", name_offset, header, 0, 0)
    return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *cached)


def _group_blocks(at: int, names: list[str], headers: list[int],
                  cached: list) -> tuple[bytes, tuple[int, int]]:
    """A symbol-table group at ``at``: its B-tree, local heap and (with
    entries) its symbol table node; and the (B-tree, heap) addresses."""
    if len(names) > 2 * _LEAF_K:
        raise ValueError(f"a group of {len(names)} entries; the writer takes at most "
                         f"{2 * _LEAF_K}")
    order = sorted(range(len(names)), key=lambda i: names[i].encode())
    btree, heap_at = at, at + _BTREE_SIZE
    heap, offsets = _heap([names[i] for i in order], heap_at)
    snod_at = heap_at + len(heap)
    keys = struct.pack("<QQQ", 0, snod_at, offsets[-1]) if names else b""
    tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0, UNDEFINED, UNDEFINED)
    tree += keys + b"\0" * (_BTREE_SIZE - len(tree) - len(keys))
    blocks = tree + heap
    if names:
        entries = b"".join(_symbol_entry(offsets[j], headers[i], cached[i])
                           for j, i in enumerate(order))
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries
        blocks += snod + b"\0" * (_SNOD_SIZE - len(snod))
    return blocks, (btree, heap_at)


def create(path: str | Path, groups: dict[str, dict[str, tuple[tuple, np.dtype]]]
           ) -> dict[str, dict[str, int]]:
    """Write an HDF5 file of ``groups`` ({group: {dataset: (shape, dtype)}})
    with every dataset's contiguous space laid out (zero until written), and
    return each dataset's byte offset in the file."""
    # addresses: superblock, root (header, B-tree, heap, node), each group
    # likewise, each dataset's header, then the data
    root_header = 96
    group_names = list(groups)
    root_size = 16 + 24 + _BTREE_SIZE + len(_heap(group_names, 0)[0]) + \
        (_SNOD_SIZE if group_names else 0)
    at = root_header + root_size
    group_at = {}
    for name, datasets in groups.items():
        group_at[name] = at
        at += 16 + 24 + _BTREE_SIZE + len(_heap(list(datasets), 0)[0]) + \
            (_SNOD_SIZE if datasets else 0)
    header_at = {}
    for name, datasets in groups.items():
        for key, (shape, dtype) in datasets.items():
            header_at[name, key] = at
            at += len(_dataset_header(tuple(shape), dtype, 0))
    offsets: dict[str, dict[str, int]] = {name: {} for name in groups}
    for name, datasets in groups.items():
        for key, (shape, dtype) in datasets.items():
            at = -(-at // _DATA_ALIGN) * _DATA_ALIGN
            offsets[name][key] = at
            at += int(np.prod(shape)) * np.dtype(dtype).itemsize
    end = at

    out = bytearray()

    def group_bytes(header_address: int, names, headers, cached) -> bytes:
        blocks, (btree, heap) = _group_blocks(header_address + 40, names, headers, cached)
        header = _object_header([_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
        return header + blocks, (btree, heap)

    group_cached, group_parts = [], []
    for name, datasets in groups.items():
        part, cached = group_bytes(group_at[name], list(datasets),
                                    [header_at[name, k] for k in datasets],
                                    [None] * len(datasets))
        group_cached.append(cached)
        group_parts.append(part)
    root, (root_btree, root_heap) = group_bytes(
        root_header, group_names, [group_at[n] for n in group_names], group_cached)
    out += SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                                   _INTERNAL_K, 0)
    out += struct.pack("<QQQQ", 0, UNDEFINED, end, UNDEFINED)
    out += _symbol_entry(0, root_header, (root_btree, root_heap))
    out += root
    for part in group_parts:
        out += part
    for name, datasets in groups.items():
        for key, (shape, dtype) in datasets.items():
            out += _dataset_header(tuple(shape), dtype, offsets[name][key])
    with open(path, "wb") as f:
        f.write(out)
        f.truncate(end)
    return offsets


def write(path: str | Path, groups: dict[str, dict[str, np.ndarray]]) -> None:
    """An HDF5 file of ``groups`` ({group: {dataset: array}})."""
    offsets = create(path, {g: {k: (a.shape, a.dtype) for k, a in d.items()}
                            for g, d in groups.items()})
    for g, datasets in groups.items():
        for k, a in datasets.items():
            if a.size:
                out = np.memmap(path, dtype=a.dtype, mode="r+", offset=offsets[g][k],
                                shape=a.shape)
                out[...] = a
                out.flush()
                del out
