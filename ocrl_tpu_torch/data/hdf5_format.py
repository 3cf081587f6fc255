"""The subset of HDF5 that the dataset collectors write, read and written
without h5py (the machine with the card has none).

The collectors (ocrl_tpu/data/collect.py:116-131 through h5py, and the
port's ``data.collect``) write groups ``TrainingSet`` / ``ValidationSet``
of contiguous, uncompressed datasets. h5py with its default ``libver``
stores them as HDF5 1.8 does: superblock version 0, groups as symbol
tables (a version-1 B-tree of ``SNOD`` nodes, their names in a local
``HEAP``), and version-1 object headers holding each dataset's dataspace,
datatype, fill value and data layout messages.

``read_layout(path)`` walks that structure and returns
``{group: {dataset: (offset, shape, dtype)}}``, which is all that
``np.memmap`` needs (ocrl_tpu/data/hdf5.py:40-53 asks h5py for the same
three things). Datatypes: little-endian fixed-point of 1, 2, 4 or 8 bytes,
signed or not, and IEEE floats of 4 or 8 bytes. Layout: version 3,
contiguous. A file outside the subset raises ``UnsupportedHDF5`` naming
what it found: a superblock of version 2 or above (``libver="latest"``),
groups stored as links (compact or dense link storage), version-2 object
headers, chunked or compact layouts, filters (compression), external
storage, big-endian or other datatypes. There is no slower path to fall
back on.

``create(path, groups)`` writes the same structures as h5py does, with
every dataset's space laid out at creation, and returns each dataset's
offset, so that a writer streams rows in with plain writes at known
offsets. A group holds at most 8 datasets (one symbol table node).
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

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x00, 0x01, 0x02, 0x03, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS = 0x06, 0x07, 0x08, 0x0A, 0x0B
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
_GROUP_AS_LINKS = {_LINK_INFO: "a link info message (dense link storage)",
                   _LINK: "link messages (compact link storage)",
                   _GROUP_INFO: "a group info message (link storage)"}


class UnsupportedHDF5(ValueError):
    """The file uses a part of HDF5 outside the subset the collectors write."""


class _File:
    def __init__(self, path: str | Path):
        self.path = str(path)
        self.f = open(path, "rb")

    def read(self, offset: int, n: int) -> bytes:
        self.f.seek(offset)
        out = self.f.read(n)
        if len(out) != n:
            raise UnsupportedHDF5(f"{self.path}: {n} bytes at {offset} lie past the end")
        return out

    def close(self):
        self.f.close()


def _u(b: bytes, at: int, n: int) -> int:
    return int.from_bytes(b[at:at + n], "little")


def _superblock(f: _File) -> tuple[int, int]:
    """(root object header address, base address)."""
    head = f.read(0, 8)
    if head != SIGNATURE:
        raise UnsupportedHDF5(f"{f.path}: no HDF5 signature at the start of the file")
    version = f.read(8, 1)[0]
    if version >= 2:
        raise UnsupportedHDF5(f"{f.path}: superblock version {version} (libver 'latest' "
                              "or newer); only versions 0 and 1 are read")
    b = f.read(8, 16)
    size_offsets, size_lengths = b[5], b[6]
    if (size_offsets, size_lengths) != (8, 8):
        raise UnsupportedHDF5(f"{f.path}: offsets of {size_offsets} and lengths of "
                              f"{size_lengths} bytes; only 8 and 8 are read")
    at = 24 + (4 if version == 1 else 0)
    b = f.read(at, 32 + _ENTRY)
    base = _u(b, 0, 8)
    return _u(b, 32 + 8, 8), base


def _messages(f: _File, address: int) -> list[tuple[int, bytes]]:
    """The (type, data) messages of the version-1 object header at
    ``address``, continuation blocks followed."""
    b = f.read(address, 16)
    if b[:4] == b"OHDR":
        raise UnsupportedHDF5(f"{f.path}: a version-2 object header at {address}")
    if b[0] != 1:
        raise UnsupportedHDF5(f"{f.path}: object header version {b[0]} at {address}")
    count = _u(b, 2, 2)
    blocks = [(address + 16, _u(b, 8, 4))]
    out = []
    while blocks and len(out) < count:
        start, size = blocks.pop(0)
        block = f.read(start, size)
        at = 0
        while at + 8 <= size and len(out) < count:
            kind, n, flags = _u(block, at, 2), _u(block, at + 2, 2), block[at + 4]
            data = block[at + 8:at + 8 + n]
            at += 8 + n
            if flags & 0x02:
                raise UnsupportedHDF5(f"{f.path}: a shared message of type {kind:#x}")
            if kind == _CONTINUATION:
                blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
            out.append((kind, data))
    return out


def _heap_name(f: _File, heap: int, offset: int) -> str:
    b = f.read(heap, 32)
    if b[:4] != b"HEAP":
        raise UnsupportedHDF5(f"{f.path}: no local heap at {heap}")
    size, data = _u(b, 8, 8), _u(b, 24, 8)
    segment = f.read(data, size)
    end = segment.index(b"\0", offset)
    return segment[offset:end].decode()


def _entries(f: _File, btree: int, heap: int) -> list[tuple[str, int]]:
    """(name, object header address) of every entry of a symbol-table group,
    in the B-tree's (name) order."""
    b = f.read(btree, 24)
    if b[:4] != b"TREE" or b[4] != 0:
        raise UnsupportedHDF5(f"{f.path}: no group B-tree at {btree}")
    level, used = b[5], _u(b, 6, 2)
    body = f.read(btree + 24, used * 16 + 8)
    children = [_u(body, 8 + 16 * i, 8) for i in range(used)]
    out = []
    for child in children:
        if level > 0:
            out += _entries(f, child, heap)
            continue
        node = f.read(child, 8)
        if node[:4] != b"SNOD":
            raise UnsupportedHDF5(f"{f.path}: no symbol table node at {child}")
        n = _u(node, 6, 2)
        entries = f.read(child + 8, n * _ENTRY)
        for i in range(n):
            e = entries[i * _ENTRY:(i + 1) * _ENTRY]
            out.append((_heap_name(f, heap, _u(e, 0, 8)), _u(e, 8, 8)))
    return out


def _dtype(f: _File, data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits, size = data[1:4], _u(data, 4, 4)
    if cls not in (0, 1):
        raise UnsupportedHDF5(f"{f.path}: datatype class {cls} (only fixed-point and "
                              "floating-point are read)")
    if bits[0] & 0x01 or (cls == 1 and bits[0] & 0x40):
        raise UnsupportedHDF5(f"{f.path}: a big-endian datatype")
    offset, precision = _u(data, 8, 2), _u(data, 10, 2)
    if offset != 0 or precision != 8 * size:
        raise UnsupportedHDF5(f"{f.path}: a datatype of {precision} bits at bit {offset} "
                              f"in {size} bytes")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise UnsupportedHDF5(f"{f.path}: an integer of {size} bytes")
        return np.dtype(f"<{'i' if bits[0] & 0x08 else 'u'}{size}")
    ieee = {4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}
    fields = (data[12], data[13], data[14], data[15], _u(data, 16, 4))
    if ieee.get(size) != fields or (bits[0] >> 4) & 0x03 != 2:
        raise UnsupportedHDF5(f"{f.path}: a floating-point type of {size} bytes that is "
                              f"not IEEE (version {version}, fields {fields})")
    return np.dtype(f"<f{size}")


def _dataset(f: _File, name: str, messages) -> tuple[int, tuple, np.dtype]:
    kinds = {kind for kind, _ in messages}
    if _FILTERS in kinds:
        raise UnsupportedHDF5(f"{f.path}: dataset '{name}' is compressed (a filter pipeline)")
    if _EXTERNAL in kinds:
        raise UnsupportedHDF5(f"{f.path}: dataset '{name}' keeps its data in external files")
    shape = dtype = layout = None
    for kind, data in messages:
        if kind == _DATASPACE:
            version, rank = data[0], data[1]
            if version == 1:
                at = 8
            elif version == 2:
                if data[3] != 1:
                    raise UnsupportedHDF5(f"{f.path}: dataset '{name}' has a dataspace "
                                          f"of type {data[3]} (scalar or null)")
                at = 4
            else:
                raise UnsupportedHDF5(f"{f.path}: dataspace version {version}")
            shape = tuple(_u(data, at + 8 * i, 8) for i in range(rank))
        elif kind == _DATATYPE:
            dtype = _dtype(f, data)
        elif kind == _LAYOUT:
            layout = data
    if shape is None or dtype is None or layout is None:
        raise UnsupportedHDF5(f"{f.path}: '{name}' lacks a dataspace, datatype or layout")
    if layout[0] != 3:
        raise UnsupportedHDF5(f"{f.path}: dataset '{name}' has a layout message of "
                              f"version {layout[0]}; only version 3 is read")
    if layout[1] != 1:
        kind = {0: "compact", 2: "chunked"}.get(layout[1], f"class {layout[1]}")
        raise UnsupportedHDF5(f"{f.path}: dataset '{name}' is {kind}, not contiguous")
    address, size = _u(layout, 2, 8), _u(layout, 10, 8)
    if size != int(np.prod(shape)) * dtype.itemsize:
        raise UnsupportedHDF5(f"{f.path}: dataset '{name}' holds {size} bytes for shape "
                              f"{shape} of {dtype}")
    return address, shape, dtype


def _group(f: _File, path: str, messages) -> tuple[int, int]:
    for kind, _ in messages:
        if kind in _GROUP_AS_LINKS:
            raise UnsupportedHDF5(f"{f.path}: group '{path}' is stored with "
                                  f"{_GROUP_AS_LINKS[kind]}; only symbol tables are read")
    for kind, data in messages:
        if kind == _SYMBOL_TABLE:
            return _u(data, 0, 8), _u(data, 8, 8)
    raise UnsupportedHDF5(f"{f.path}: '{path}' is neither a dataset nor a group")


def read_layout(path: str | Path) -> dict[str, dict[str, tuple[int, tuple, np.dtype]]]:
    """``{group: {dataset: (offset, shape, dtype)}}`` of the file's top-level
    groups, in name order. A dataset whose space was never written has
    offset None (as h5py's ``get_offset()``)."""
    f = _File(path)
    try:
        root, base = _superblock(f)
        out = {}
        for name, address in _entries(f, *_group(f, "/", _messages(f, root))):
            messages = _messages(f, address)
            if not any(kind == _SYMBOL_TABLE for kind, _ in messages) and \
                    not any(kind in _GROUP_AS_LINKS for kind, _ in messages):
                raise UnsupportedHDF5(f"{f.path}: '/{name}' is a dataset, not a group")
            datasets = {}
            for key, child in _entries(f, *_group(f, f"/{name}", messages)):
                offset, shape, dtype = _dataset(f, f"/{name}/{key}", _messages(f, child))
                datasets[key] = (None if offset == UNDEFINED else base + offset, shape,
                                 dtype)
            out[name] = datasets
        return out
    finally:
        f.close()


# -- the writer ------------------------------------------------------------------

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
