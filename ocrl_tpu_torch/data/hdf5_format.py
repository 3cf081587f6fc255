"""HDF5 read and written without h5py (the machine with the card has none).

Reading: ``read_layout(path)`` walks the file's top-level groups and returns
``{group: {dataset: spec}}`` in name order, where a dataset's spec is

- contiguous: ``(offset, shape, dtype)``, all that ``np.memmap`` needs
  (ocrl_tpu/data/hdf5.py:40-53 asks h5py for the same three things); the
  offset is None where the space was never written, as h5py's
  ``get_offset()``;
- chunked: a ``Chunked``: the chunk shape, the filter pipeline, the fill
  value and the chunk index, each stored chunk's coordinates, file offset,
  stored size and filter mask; ``decode_chunk`` undoes a chunk's filters;
- compact: a ``Compact`` holding the bytes kept in the object header.

It reads, from the HDF5 file format specification, what JAX's loader reads
through h5py (ocrl_tpu/data/hdf5.py:65-84): the files h5py 3 writes through
``h5py.File``'s and ``create_dataset``'s own arguments. The writer of each
part, in parentheses:

- superblocks 0 to 3 (0 by default, 2 and 3 with their checksum under
  ``libver="v108"`` or later), at the file's start or after a user block
  (``userblock_size``), with offsets and lengths of 8 bytes;
- object headers of version 1 (by default) and of version 2 (``OHDR`` with
  ``OCHK`` continuation blocks, their flag bits honoured; ``libver`` from
  ``"v108"``, or ``track_order=True``);
- groups as symbol tables (a version-1 B-tree of ``SNOD`` nodes, the names
  in a local ``HEAP``; by default) or as links, compact (link messages;
  ``libver`` from ``"v108"``) or dense (a link info message's fractal heap
  and its version-2 B-tree of name hashes; the same with more than 8
  members in a group); hard links only;
- datatypes: fixed-point of 1, 2, 4 or 8 bytes, signed or not, and IEEE
  floats of 2, 4 or 8 bytes, little- or big-endian (numpy's ``<`` / ``>``;
  the array's own dtype);
- data layout messages of version 3 (contiguous, compact, chunked under a
  version-1 B-tree: ``chunks``, ``compression`` or ``maxshape``, by
  default) and 4 (``libver`` from ``"v110"``, which SWMR appending needs:
  chunked under a single-chunk, implicit, fixed-array, extensible-array
  (``maxshape=(None, ...)``) or version-2 B-tree (two ``None``) index);
- filters: deflate (1; ``compression="gzip"``), shuffle (2), fletcher32
  (3) and h5py's LZF (32000; ``compression="lzf"``), each chunk's filter
  mask honoured; a fill value for chunks never written (``resize`` past
  what was written).

Every checksum of version-2 metadata (Jenkins' lookup3) and every
fletcher32 chunk is verified; a mismatch raises ``HDF5ChecksumError``, an
OSError as h5py's. Anything else raises ``UnsupportedHDF5`` naming what it
found: szip, nbit, scaleoffset and any other filter; external storage and
the virtual layout; string, compound, variable-length and the other
datatype classes; soft and external links; shared messages; offsets or
lengths other than 8 bytes. There is no slower path to fall back on.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from .. import native

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
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS = 0x06, 0x07, 0x08, 0x0A, 0x0B
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11

DEFLATE, SHUFFLE, FLETCHER32, LZF = 1, 2, 3, 32000
FILTER_NAMES = {DEFLATE: "deflate", SHUFFLE: "shuffle", FLETCHER32: "fletcher32",
                4: "szip", 5: "nbit", 6: "scaleoffset", LZF: "lzf"}
_DATATYPE_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield", "opaque",
                     "compound", "reference", "enumerated", "variable-length", "array")
_INDEX_TYPES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                5: "version-2 B-tree"}


class UnsupportedHDF5(ValueError):
    """The file uses a part of HDF5 that the reader does not read."""


class HDF5ChecksumError(OSError):
    """A metadata checksum or a chunk's fletcher32 checksum does not match."""


@dataclasses.dataclass(frozen=True)
class Filter:
    """A filter of a dataset's pipeline: its id, name and client data."""

    id: int
    name: str
    values: tuple[int, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Chunked:
    """A chunked dataset: rows [n, ...] of ``dtype`` stored in chunks of
    ``chunks``; chunk i of the index sits at ``coords[i] * chunks``, its
    ``sizes[i]`` bytes at file offset ``offsets[i]``, filter j of
    ``filters`` skipped where bit j of ``masks[i]`` is set. A chunk absent
    from the index was never written and reads as ``fill`` (one element's
    bytes). ``index`` names the index type."""

    shape: tuple[int, ...]
    dtype: np.dtype
    chunks: tuple[int, ...]
    filters: tuple[Filter, ...]
    fill: bytes
    index: str
    coords: np.ndarray          # [n, rank] int64
    offsets: np.ndarray         # [n] int64
    sizes: np.ndarray           # [n] int64
    masks: np.ndarray           # [n] int64

    @property
    def chunk_nbytes(self) -> int:
        return int(np.prod(self.chunks)) * self.dtype.itemsize

    @property
    def grid(self) -> tuple[int, ...]:
        """The number of chunks along each dimension of the current shape."""
        return tuple(-(-n // c) for n, c in zip(self.shape, self.chunks))


@dataclasses.dataclass(frozen=True)
class Compact:
    """A compact dataset: its bytes were kept in its object header."""

    shape: tuple[int, ...]
    dtype: np.dtype
    data: bytes

    def array(self) -> np.ndarray:
        return np.frombuffer(self.data, self.dtype).reshape(self.shape)


class _File:
    def __init__(self, path: str | Path):
        self.path = str(path)
        self.f = open(path, "rb")
        self.base = 0                       # addresses are relative to this

    def read(self, address: int, n: int) -> bytes:
        self.f.seek(self.base + address)
        out = self.f.read(n)
        if len(out) != n:
            raise UnsupportedHDF5(f"{self.path}: {n} bytes at {address} lie past the end")
        return out

    def checked(self, address: int, n: int, what: str, zeroed: int | None = None) -> bytes:
        """``n`` bytes at ``address`` whose last four (or the four at
        ``zeroed``, hashed as zeros) are the lookup3 checksum of the rest."""
        block = self.read(address, n)
        if zeroed is None:
            body, stored = block[:-4], _u(block, n - 4, 4)
        else:
            body = block[:zeroed] + b"\0\0\0\0" + block[zeroed + 4:]
            stored = _u(block, zeroed, 4)
        if native.lookup3(body) != stored:
            raise HDF5ChecksumError(f"{self.path}: the checksum of {what} at {address} does "
                                    "not match")
        return block

    def fail(self, what: str) -> UnsupportedHDF5:
        return UnsupportedHDF5(f"{self.path}: {what}")

    def close(self):
        self.f.close()


def _u(b: bytes, at: int, n: int) -> int:
    return int.from_bytes(b[at:at + n], "little")


def _enc_size(n: int) -> int:
    """Bytes HDF5 takes to encode counts up to ``n`` (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _superblock(f: _File) -> int:
    """The root group's object header address; sets the base address."""
    size = os.fstat(f.f.fileno()).st_size
    at = 0
    while at + 8 > size or f.read(at, 8) != SIGNATURE:
        if at + 8 > size:
            raise f.fail("no HDF5 signature at the start of the file or after a user block")
        at = 512 if at == 0 else 2 * at
    version = f.read(at + 8, 1)[0]
    if version in (0, 1):
        b = f.read(at + 8, 16)
        sizes = b[5], b[6]
        b = f.read(at + 24 + (4 if version == 1 else 0), 32 + _ENTRY)
        base, root = _u(b, 0, 8), _u(b, 32 + 8, 8)
    elif version in (2, 3):
        b = f.checked(at, 48, "the superblock")
        sizes = b[9], b[10]
        base, root = _u(b, 12, 8), _u(b, 36, 8)
    else:
        raise f.fail(f"superblock version {version}")
    if sizes != (8, 8):
        raise f.fail(f"offsets of {sizes[0]} and lengths of {sizes[1]} bytes; only 8 and 8 "
                     "are read")
    f.base = base
    return root


def _messages(f: _File, address: int) -> list[tuple[int, bytes]]:
    """The (type, data) messages of the object header at ``address``,
    continuation blocks followed."""
    b = f.read(address, 16)
    if b[:4] == b"OHDR":
        return _messages_v2(f, address)
    if b[0] != 1:
        raise f.fail(f"object header version {b[0]} at {address}")
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
            out.append(_message_of(f, kind, flags, data, blocks))
    return out


def _messages_v2(f: _File, address: int) -> list[tuple[int, bytes]]:
    b = f.read(address, 6)
    if b[4] != 2:
        raise f.fail(f"an OHDR object header of version {b[4]} at {address}")
    flags = b[5]
    at = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    size0 = _u(f.read(address + at, width), 0, width)
    at += width
    block = f.checked(address, at + size0 + 4, "an object header")
    head = 6 if flags & 0x04 else 4                 # the creation order of each message
    regions, out = [block[at:at + size0]], []
    while regions:
        region = regions.pop(0)
        pos, blocks = 0, []
        while pos + head <= len(region):            # fewer bytes left: a gap
            kind, n, mflags = region[pos], _u(region, pos + 1, 2), region[pos + 3]
            data = region[pos + head:pos + head + n]
            pos += head + n
            out.append(_message_of(f, kind, mflags, data, blocks))
        for start, size in blocks:
            cont = f.checked(start, size, "an object header continuation block")
            if cont[:4] != b"OCHK":
                raise f.fail(f"no OCHK continuation block at {start}")
            regions.append(cont[4:-4])
    return out


def _message_of(f: _File, kind: int, flags: int, data: bytes, blocks: list):
    if flags & 0x02:
        raise f.fail(f"a shared message of type {kind:#x}")
    if kind == _CONTINUATION:
        blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
    return kind, data


# -- groups ----------------------------------------------------------------------

def _heap_name(f: _File, heap: int, offset: int) -> str:
    b = f.read(heap, 32)
    if b[:4] != b"HEAP":
        raise f.fail(f"no local heap at {heap}")
    size, data = _u(b, 8, 8), _u(b, 24, 8)
    segment = f.read(data, size)
    end = segment.index(b"\0", offset)
    return segment[offset:end].decode()


def _entries(f: _File, path: str, btree: int, heap: int) -> list[tuple[str, int]]:
    """(name, object header address) of every entry of a symbol-table group."""
    b = f.read(btree, 24)
    if b[:4] != b"TREE" or b[4] != 0:
        raise f.fail(f"no group B-tree at {btree}")
    level, used = b[5], _u(b, 6, 2)
    body = f.read(btree + 24, used * 16 + 8)
    out = []
    for child in (_u(body, 8 + 16 * i, 8) for i in range(used)):
        if level > 0:
            out += _entries(f, path, child, heap)
            continue
        node = f.read(child, 8)
        if node[:4] != b"SNOD":
            raise f.fail(f"no symbol table node at {child}")
        n = _u(node, 6, 2)
        entries = f.read(child + 8, n * _ENTRY)
        for i in range(n):
            e = entries[i * _ENTRY:(i + 1) * _ENTRY]
            name = _heap_name(f, heap, _u(e, 0, 8))
            if _u(e, 16, 4) == 2:                   # the entry caches a soft link
                raise f.fail(f"'{path.rstrip('/')}/{name}' is a soft link; only hard links "
                             "are followed")
            out.append((name, _u(e, 8, 8)))
    return out


def _link(f: _File, path: str, data: bytes) -> tuple[str, int]:
    """(name, object header address) of a link message; only hard links."""
    flags, at, kind = data[1], 2, 0
    if data[0] != 1:
        raise f.fail(f"a link message of version {data[0]} in '{path}'")
    if flags & 0x08:
        kind, at = data[at], at + 1
    at += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    n = _u(data, at, width)
    name = data[at + width:at + width + n].decode()
    if kind != 0:
        what = {1: "a soft", 64: "an external"}.get(kind, f"a user-defined (type {kind})")
        raise f.fail(f"'{path.rstrip('/')}/{name}' is {what} link; only hard links are "
                     "followed")
    return name, _u(data, at + width + n, 8)


class _FractalHeap:
    """The managed and tiny objects of a fractal heap (a dense group's link
    messages)."""

    def __init__(self, f: _File, address: int):
        b = f.read(address, 146)
        if b[:4] != b"FRHP" or b[4] != 0:
            raise f.fail(f"no fractal heap at {address}")
        if _u(b, 7, 2):
            raise f.fail(f"a fractal heap with I/O filters at {address}")
        f.checked(address, 146, "a fractal heap header")
        self.f, self.id_len, self.checksummed = f, _u(b, 5, 2), bool(b[9] & 0x02)
        max_managed = _u(b, 10, 4)
        self.width, self.start, max_direct = _u(b, 110, 2), _u(b, 112, 8), _u(b, 120, 8)
        max_bits, self.root, self.rows = _u(b, 128, 2), _u(b, 132, 8), _u(b, 140, 2)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, _enc_size(max_managed))
        self.direct_rows = _log2(max_direct) - _log2(self.start) + 2
        self.first_bits = _log2(self.start) + _log2(self.width)
        self.blocks: dict[int, bytes] = {}

    def row_size(self, row: int) -> int:
        return self.start << max(row - 1, 0)

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 0x03
        if heap_id[0] >> 6 or kind == 1:
            raise self.f.fail("a fractal heap object that is huge or of an unknown version")
        if kind == 2:
            if self.id_len > 18:
                raise self.f.fail("an extended tiny fractal heap object")
            return heap_id[1:1 + (heap_id[0] & 0x0F) + 1]
        offset = _u(heap_id, 1, self.off_size)
        length = _u(heap_id, 1 + self.off_size, self.len_size)
        block, block_offset, size = (self.root, 0, self.start) if self.rows == 0 else \
            self._find(self.root, self.rows, 0, offset)
        data = self._direct(block, size)
        return data[offset - block_offset:offset - block_offset + length]

    def _direct(self, address: int, size: int) -> bytes:
        if address not in self.blocks:
            if self.checksummed:
                data = self.f.checked(address, size, "a fractal heap direct block",
                                      zeroed=4 + 1 + 8 + self.off_size)
            else:
                data = self.f.read(address, size)
            if data[:4] != b"FHDB":
                raise self.f.fail(f"no fractal heap direct block at {address}")
            self.blocks[address] = data
        return self.blocks[address]

    def _find(self, address: int, rows: int, start: int, offset: int):
        """(direct block address, its heap offset, its size) holding ``offset``
        under the indirect block at ``address`` of ``rows`` rows."""
        entries = rows * self.width
        block = self.f.checked(address, 13 + self.off_size + 8 * entries + 4,
                               "a fractal heap indirect block")
        if block[:4] != b"FHIB":
            raise self.f.fail(f"no fractal heap indirect block at {address}")
        at = start
        for i in range(entries):
            row, size = i // self.width, self.row_size(i // self.width)
            if at <= offset < at + size:
                child = _u(block, 13 + self.off_size + 8 * i, 8)
                if child == UNDEFINED:
                    raise self.f.fail("a fractal heap object in an unallocated block")
                if row < self.direct_rows:
                    return child, at, size
                return self._find(child, _log2(size) - self.first_bits + 1, at, offset)
            at += size
        raise self.f.fail(f"a fractal heap offset {offset} outside its indirect block")


def _btree2(f: _File, address: int, kinds: tuple[int, ...]) -> tuple[int, list[bytes]]:
    """(record type, every record) of the version-2 B-tree at ``address``."""
    b = f.checked(address, 38, "a version-2 B-tree header")
    if b[:4] != b"BTHD" or b[4] != 0:
        raise f.fail(f"no version-2 B-tree at {address}")
    kind, node_size, rec_size, depth = b[5], _u(b, 6, 4), _u(b, 10, 2), _u(b, 12, 2)
    if kind not in kinds:
        raise f.fail(f"a version-2 B-tree of record type {kind} at {address}")
    # the fields' widths, as H5B2__hdr_init derives them from the node size
    leaf_max = (node_size - 10) // rec_size
    nrec_size, cum, cum_size = _enc_size(leaf_max), [leaf_max], [0]
    for d in range(1, depth + 1):
        pointer = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        most = (node_size - (10 + pointer)) // (rec_size + pointer)
        cum.append((most + 1) * cum[d - 1] + most)
        cum_size.append(_enc_size(cum[d]))
    records: list[bytes] = []

    def walk(node: int, nrec: int, d: int) -> None:
        if d == 0:
            leaf = f.checked(node, 6 + nrec * rec_size + 4, "a version-2 B-tree leaf")
            if leaf[:4] != b"BTLF":
                raise f.fail(f"no version-2 B-tree leaf at {node}")
            records.extend(leaf[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(nrec))
            return
        pointer = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        inner = f.checked(node, 6 + nrec * rec_size + (nrec + 1) * pointer + 4,
                          "a version-2 B-tree internal node")
        if inner[:4] != b"BTIN":
            raise f.fail(f"no version-2 B-tree internal node at {node}")
        for i in range(nrec + 1):
            at = 6 + nrec * rec_size + i * pointer
            walk(_u(inner, at, 8), _u(inner, at + 8, nrec_size), d - 1)
            if i < nrec:
                records.append(inner[6 + i * rec_size:6 + (i + 1) * rec_size])

    if _u(b, 16, 8) != UNDEFINED:
        walk(_u(b, 16, 8), _u(b, 24, 2), depth)
    return kind, records


def _links(f: _File, path: str, messages) -> list[tuple[str, int]]:
    """(name, object header address) of a group's members, in name order."""
    kinds = {kind for kind, _ in messages}
    if _SYMBOL_TABLE in kinds:
        data = next(d for k, d in messages if k == _SYMBOL_TABLE)
        out = _entries(f, path, _u(data, 0, 8), _u(data, 8, 8))
    elif _LINK_INFO in kinds or _LINK in kinds:
        out = [_link(f, path, d) for k, d in messages if k == _LINK]
        for info in (d for k, d in messages if k == _LINK_INFO):
            at = 2 + (8 if info[1] & 0x01 else 0)
            heap_address, names = _u(info, at, 8), _u(info, at + 8, 8)
            if heap_address != UNDEFINED:
                heap = _FractalHeap(f, heap_address)
                _, records = _btree2(f, names, (5,))
                out += [_link(f, path, heap.get(r[4:4 + heap.id_len])) for r in records]
    else:
        raise f.fail(f"'{path}' is neither a dataset nor a group")
    return sorted(out, key=lambda e: e[0].encode())


# -- datasets --------------------------------------------------------------------

def _dtype(f: _File, name: str, data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits, size = data[1:4], _u(data, 4, 4)
    if cls not in (0, 1):
        what = _DATATYPE_CLASSES[cls] if cls < len(_DATATYPE_CLASSES) else f"class-{cls}"
        raise f.fail(f"dataset '{name}' has a datatype of class {what}; only fixed-point "
                     "and IEEE floating-point are read")
    order = bits[0] & 0x01 | (bits[0] >> 5 & 0x02 if cls == 1 else 0)
    if order > 1:
        raise f.fail(f"dataset '{name}' has a VAX-ordered floating-point datatype")
    offset, precision = _u(data, 8, 2), _u(data, 10, 2)
    if offset != 0 or precision != 8 * size:
        raise f.fail(f"dataset '{name}' has a datatype of {precision} bits at bit {offset} "
                     f"in {size} bytes")
    endian = ">" if order else "<"
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise f.fail(f"dataset '{name}' has an integer of {size} bytes")
        return np.dtype(f"{endian}{'i' if bits[0] & 0x08 else 'u'}{size}")
    ieee = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}
    fields = (data[12], data[13], data[14], data[15], _u(data, 16, 4))
    if ieee.get(size) != fields or (bits[0] >> 4) & 0x03 != 2:
        raise f.fail(f"dataset '{name}' has a floating-point type of {size} bytes that is "
                     f"not IEEE (version {version}, fields {fields})")
    return np.dtype(f"{endian}f{size}")


def _dataspace(f: _File, name: str, data: bytes) -> tuple[tuple, tuple]:
    """(shape, maxshape), None in maxshape for an unlimited dimension."""
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        at = 8
    elif version == 2:
        if data[3] != 1:
            raise f.fail(f"dataset '{name}' has a dataspace of type {data[3]} (scalar or "
                         "null)")
        at = 4
    else:
        raise f.fail(f"dataset '{name}' has a dataspace of version {version}")
    shape = tuple(_u(data, at + 8 * i, 8) for i in range(rank))
    if not flags & 0x01:
        return shape, shape
    most = tuple(_u(data, at + 8 * (rank + i), 8) for i in range(rank))
    return shape, tuple(None if m == UNDEFINED else m for m in most)


def _filters(f: _File, name: str, data: bytes) -> tuple[Filter, ...]:
    version, count = data[0], data[1]
    if version not in (1, 2):
        raise f.fail(f"dataset '{name}' has a filter pipeline of version {version}")
    at, out = (8 if version == 1 else 2), []
    for _ in range(count):
        fid, at = _u(data, at, 2), at + 2
        width = 0
        if version == 1 or fid >= 256:
            width, at = _u(data, at, 2), at + 2
        nvalues, at = _u(data, at + 2, 2), at + 4          # after the flags
        label = data[at:at + width].split(b"\0")[0].decode(errors="replace")
        at += -(-width // 8) * 8 if version == 1 else width
        values = tuple(_u(data, at + 4 * i, 4) for i in range(nvalues))
        at += 4 * nvalues + (4 if version == 1 and nvalues % 2 else 0)
        known = FILTER_NAMES.get(fid)
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32, LZF):
            what = f"the {known} filter" if known else \
                f"the plugin filter {fid}" + (f" ('{label}')" if label else "")
            raise f.fail(f"dataset '{name}' uses {what}; only deflate, shuffle, fletcher32 "
                         "and lzf are read")
        out.append(Filter(fid, known, values))
    return tuple(out)


def _fill(messages, dtype: np.dtype) -> bytes:
    """One element's bytes of the fill value (zeros where none is set)."""
    value = b""
    for kind, data in messages:
        if kind == _FILL and data[0] in (1, 2) and (data[0] == 1 or data[3]):
            value = data[8:8 + _u(data, 4, 4)]
        elif kind == _FILL and data[0] == 3 and data[1] & 0x20:
            value = data[6:6 + _u(data, 2, 4)]
        elif kind == _FILL_OLD and not value:
            value = data[4:4 + _u(data, 0, 4)]
    return value if len(value) == dtype.itemsize else b"\0" * dtype.itemsize


def _element_table(raw: bytes, size: int, filtered: bool, rank: int = 0):
    """(addresses, stored sizes, masks, coordinates) of chunk records of
    ``size`` bytes: the address; for filtered chunks the stored size in the
    bytes left and the mask; then (a version-2 B-tree's) ``rank`` scaled
    coordinates. Sizes and masks are None unfiltered, coordinates without
    a rank."""
    a = np.frombuffer(raw, np.uint8).reshape(-1, size)
    addresses = a[:, :8].copy().view("<u8")[:, 0]
    coords = a[:, size - 8 * rank:].copy().view("<u8").astype(np.int64) if rank else None
    if not filtered:
        return addresses, None, None, coords
    width = size - 12 - 8 * rank
    sizes = sum(a[:, 8 + j].astype(np.int64) << (8 * j) for j in range(width))
    masks = a[:, 8 + width:12 + width].copy().view("<u4")[:, 0]
    return addresses, sizes, masks, coords


def _bit(bitmap: bytes, i: int) -> bool:
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _fixed_array(f: _File, address: int):
    h = f.checked(address, 28, "a fixed array header")
    if h[:4] != b"FAHD":
        raise f.fail(f"no fixed array header at {address}")
    client, esize, page_bits, n, block = h[5], h[6], h[7], _u(h, 8, 8), _u(h, 16, 8)
    page = 1 << page_bits
    if n <= page:
        raw = f.checked(block, 14 + n * esize + 4, "a fixed array data block")[14:-4]
    else:
        pages = -(-n // page)
        prefix = 14 + (pages + 7) // 8 + 4
        head = f.checked(block, prefix, "a fixed array data block")
        parts = []
        for p in range(pages):
            count = min(page, n - p * page)
            if _bit(head[14:], p):
                parts.append(f.checked(block + prefix + p * (page * esize + 4),
                                       count * esize + 4, "a fixed array page")[:-4])
            else:
                parts.append(b"\xff" * (count * esize))
        raw = b"".join(parts)
    return _element_table(raw, esize, client == 1)


def _extensible_array(f: _File, address: int, needed: int):
    """The first ``needed`` elements of the extensible array at ``address``
    (H5EA's index block, super blocks and paged data blocks)."""
    h = f.checked(address, 72, "an extensible array header")
    if h[:4] != b"EAHD":
        raise f.fail(f"no extensible array header at {address}")
    client, esize, max_bits, in_index, dblk_min, sblk_min, page_bits = h[5:12]
    iblock = _u(h, 60, 8)
    off_size, page = (max_bits + 7) // 8, 1 << page_bits
    nsblks = 1 + max_bits - _log2(dblk_min)
    iblock_sblks = 2 * _log2(sblk_min)
    ndblk_addrs, nsblk_addrs = 2 * (sblk_min - 1), nsblks - iblock_sblks

    def missing(count: int) -> bytes:                   # elements never written
        return b"\xff" * (count * esize)

    if iblock == UNDEFINED:
        return _element_table(missing(needed), esize, client == 1)
    ib = f.checked(iblock, 14 + in_index * esize + 8 * (ndblk_addrs + nsblk_addrs) + 4,
                   "an extensible array index block")
    if ib[:4] != b"EAIB":
        raise f.fail(f"no extensible array index block at {iblock}")
    at = 14 + in_index * esize
    dblocks = [_u(ib, at + 8 * i, 8) for i in range(ndblk_addrs)]
    sblocks = [_u(ib, at + 8 * (ndblk_addrs + i), 8) for i in range(nsblk_addrs)]
    parts, have = [ib[14:at]], in_index

    def data_block(addr: int, count: int, bitmap: bytes, first: int) -> bytes:
        """A data block's elements; a paged one's pages as its secondary
        block's bitmap marks them, from bit ``first``."""
        if addr == UNDEFINED:
            return missing(count)
        if count <= page:
            b = f.checked(addr, 14 + off_size + count * esize + 4,
                          "an extensible array data block")
            return b[14 + off_size:-4]
        prefix, out = 14 + off_size + 4, []
        for p in range(count // page):
            if _bit(bitmap, first + p):
                out.append(f.checked(addr + prefix + p * (page * esize + 4), page * esize + 4,
                                     "an extensible array page")[:-4])
            else:
                out.append(missing(page))
        return b"".join(out)

    dblk_index = 0
    for s in range(nsblks):
        if have >= needed:
            break
        count, per = 1 << (s // 2), (1 << ((s + 1) // 2)) * dblk_min
        if s < iblock_sblks:
            if per > page:
                raise f.fail("a paged extensible array data block in the index block")
            for d in range(count):
                parts.append(data_block(dblocks[dblk_index + d], per, b"", 0))
            dblk_index += count
        elif sblocks[s - iblock_sblks] == UNDEFINED:
            parts.append(missing(count * per))
        else:
            npages = per // page if per > page else 0
            bitmap_len = count * ((npages + 7) // 8)    # H5EA_SBLOCK_SIZE: bytes a data block
            sb = f.checked(sblocks[s - iblock_sblks], 14 + off_size + bitmap_len + 8 * count + 4,
                           "an extensible array secondary block")
            if sb[:4] != b"EASB":
                raise f.fail(f"no extensible array secondary block at {sblocks[s - iblock_sblks]}")
            bitmap = sb[14 + off_size:14 + off_size + bitmap_len]
            at = 14 + off_size + bitmap_len
            for d in range(count):
                parts.append(data_block(_u(sb, at + 8 * d, 8), per, bitmap, d * npages))
        have += count * per
    raw = b"".join(parts)[:needed * esize]
    raw += missing(needed - len(raw) // esize)
    return _element_table(raw, esize, client == 1)


def _btree1_chunks(f: _File, address: int, rank: int) -> np.ndarray:
    """The leaf keys of a chunk B-tree: (size, mask, element offsets, address)."""
    entry = np.dtype([("size", "<u4"), ("mask", "<u4"), ("offset", "<u8", (rank + 1,)),
                      ("address", "<u8")])
    out = []

    def walk(node: int) -> None:
        b = f.read(node, 24)
        if b[:4] != b"TREE" or b[4] != 1:
            raise f.fail(f"no chunk B-tree node at {node}")
        level, used = b[5], _u(b, 6, 2)
        keys = np.frombuffer(f.read(node + 24, used * entry.itemsize), entry)
        if level == 0:
            out.append(keys)
        else:
            for child in keys["address"]:
                walk(int(child))

    walk(address)
    return np.concatenate(out) if out else np.zeros(0, entry)


def _chunked(f: _File, name: str, layout: bytes, shape: tuple, maxshape: tuple,
             dtype: np.dtype, filters: tuple[Filter, ...], fill: bytes) -> Chunked:
    rank = len(shape)
    if layout[0] == 3:
        dims = [_u(layout, 11 + 4 * i, 4) for i in range(layout[2])]
        kind, address = 0, _u(layout, 3, 8)
    else:
        flags, ndims, width = layout[2], layout[3], layout[4]
        dims = [_u(layout, 5 + width * i, width) for i in range(ndims)]
        at = 5 + width * ndims
        kind, at = layout[at], at + 1
        if flags & 0x01:
            raise f.fail(f"dataset '{name}' leaves its partial edge chunks unfiltered")
        if kind not in _INDEX_TYPES:
            raise f.fail(f"dataset '{name}' has a chunk index of type {kind}")
        single = (_u(layout, at, 8), _u(layout, at + 8, 4)) if kind == 1 and flags & 0x02 \
            else None
        at += {1: 12 if single else 0, 2: 0, 3: 1, 4: 5, 5: 6}[kind]
        address = _u(layout, at, 8)
    chunks = tuple(dims[:rank])
    if len(dims) != rank + 1 or dims[rank] != dtype.itemsize:
        raise f.fail(f"dataset '{name}' has chunk dimensions {dims} for rank {rank} and "
                     f"{dtype.itemsize}-byte elements")
    nbytes = int(np.prod(chunks)) * dtype.itemsize
    # the chunk grid of the largest shape: the array indexes' order
    most = tuple(-(-(m if m is not None else n) // c) for n, m, c in zip(shape, maxshape, chunks))
    grid = tuple(-(-n // c) for n, c in zip(shape, chunks))
    coords = sizes = masks = None
    if address == UNDEFINED:                            # nothing written
        offsets = np.zeros(0, np.int64)
    elif kind == 0:
        keys = _btree1_chunks(f, address, rank)
        offsets, sizes, masks = keys["address"], keys["size"], keys["mask"]
        coords = keys["offset"][:, :rank].astype(np.int64) // np.asarray(chunks, np.int64)
    elif kind == 1:
        offsets = np.asarray([address], np.uint64)
        coords = np.zeros((1, rank), np.int64)
        sizes, masks = (np.asarray([single[0]]), np.asarray([single[1]])) if single else \
            (None, None)
    elif kind == 2:
        n = int(np.prod(most))
        offsets = address + nbytes * np.arange(n, dtype=np.uint64)
    elif kind == 3:
        offsets, sizes, masks, _ = _fixed_array(f, address)
    elif kind == 4:
        unlimited = [d for d in range(rank) if maxshape[d] is None]
        if len(unlimited) != 1:
            raise f.fail(f"dataset '{name}' has an extensible array index over "
                         f"{len(unlimited)} unlimited dimensions")
        u = unlimited[0]
        others = [d for d in range(rank) if d != u]
        down = int(np.prod([most[d] for d in others]))
        offsets, sizes, masks, _ = _extensible_array(f, address, grid[u] * down)
        i = np.arange(len(offsets), dtype=np.int64)
        coords = np.zeros((len(i), rank), np.int64)
        coords[:, u] = i // down
        if others:
            rest = np.unravel_index(i % down, [most[d] for d in others])
            for d, c in zip(others, rest):
                coords[:, d] = c
    else:
        rtype, records = _btree2(f, address, (10, 11))
        offsets, sizes, masks, coords = _element_table(
            b"".join(records), len(records[0]), rtype == 11, rank) if records else \
            (np.zeros(0, np.uint64), None, None, None)
    offsets = np.asarray(offsets, np.uint64)
    if coords is None:
        coords = np.stack(np.unravel_index(np.arange(len(offsets)), most), axis=1) \
            if len(offsets) else np.zeros((0, rank), np.int64)
    coords = np.asarray(coords, np.int64).reshape(-1, rank)
    sizes = np.full(len(offsets), nbytes, np.int64) if sizes is None else \
        np.asarray(sizes, np.int64)
    masks = np.zeros(len(offsets), np.int64) if masks is None else np.asarray(masks, np.int64)
    # chunks never written, or lying outside the current shape, are left out
    keep = (offsets != UNDEFINED) & (coords < np.asarray(grid, np.int64)).all(axis=1)
    return Chunked(shape, dtype, chunks, filters, fill, _INDEX_TYPES.get(kind, "version-1 B-tree"),
                   coords[keep], offsets[keep].astype(np.int64) + f.base, sizes[keep],
                   masks[keep])


def _dataset(f: _File, name: str, messages):
    kinds = {kind for kind, _ in messages}
    if _EXTERNAL in kinds:
        raise f.fail(f"dataset '{name}' keeps its data in external files")
    shape = maxshape = dtype = layout = None
    filters: tuple[Filter, ...] = ()
    for kind, data in messages:
        if kind == _DATASPACE:
            shape, maxshape = _dataspace(f, name, data)
        elif kind == _DATATYPE:
            dtype = _dtype(f, name, data)
        elif kind == _LAYOUT:
            layout = data
        elif kind == _FILTERS:
            filters = _filters(f, name, data)
    if shape is None or dtype is None or layout is None:
        raise f.fail(f"'{name}' lacks a dataspace, datatype or layout")
    if layout[0] not in (3, 4):
        raise f.fail(f"dataset '{name}' has a layout message of version {layout[0]}; "
                     "versions 3 and 4 are read")
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if layout[1] == 0:
        size = _u(layout, 2, 2)
        if size != nbytes:
            raise f.fail(f"dataset '{name}' holds {size} compact bytes for shape {shape} "
                         f"of {dtype}")
        return Compact(shape, dtype, bytes(layout[4:4 + size]))
    if layout[1] == 1:
        address, size = _u(layout, 2, 8), _u(layout, 10, 8)
        if size != nbytes:
            raise f.fail(f"dataset '{name}' holds {size} bytes for shape {shape} of {dtype}")
        return None if address == UNDEFINED else f.base + address, shape, dtype
    if layout[1] == 2:
        return _chunked(f, name, layout, shape, maxshape, dtype, filters,
                        _fill(messages, dtype))
    what = "virtual" if layout[1] == 3 else f"of layout class {layout[1]}"
    raise f.fail(f"dataset '{name}' is {what}; contiguous, compact and chunked are read")


def _is_group(messages) -> bool:
    return any(kind in (_SYMBOL_TABLE, _LINK_INFO, _LINK) for kind, _ in messages)


def read_layout(path: str | Path) -> dict[str, dict]:
    """``{group: {dataset: spec}}`` of the file's top-level groups, in name
    order (see the module docstring for each spec)."""
    f = _File(path)
    try:
        root = _superblock(f)
        out = {}
        for name, address in _links(f, "/", _messages(f, root)):
            messages = _messages(f, address)
            if not _is_group(messages):
                raise f.fail(f"'/{name}' is a dataset, not a group")
            out[name] = {key: _dataset(f, f"/{name}/{key}", _messages(f, child))
                         for key, child in _links(f, f"/{name}", messages)}
        return out
    finally:
        f.close()


def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    planes = np.frombuffer(data, np.uint8, count=n * size).reshape(size, n)
    return planes.T.tobytes() + data[n * size:]


def decode_chunk(spec: Chunked, raw: bytes, mask: int) -> bytes:
    """The chunk's bytes (``spec.chunk_nbytes`` of them) from the ``raw``
    bytes stored, each filter of the pipeline undone in reverse order
    unless bit i of ``mask`` says filter i was skipped."""
    data = raw
    active = [i for i in range(len(spec.filters)) if not mask >> i & 1]
    for i in reversed(active):
        filt = spec.filters[i]
        if filt.id == FLETCHER32:
            if len(data) < 4:
                raise HDF5ChecksumError(f"a fletcher32 chunk of {len(data)} bytes")
            stored, data = _u(data, len(data) - 4, 4), data[:-4]
            want = native.fletcher32(data)
            swapped = ((want >> 8) & 0x00FF00FF) | ((want & 0x00FF00FF) << 8)
            if stored not in (want, swapped):
                raise HDF5ChecksumError("data error detected by fletcher32 checksum")
        elif filt.id == DEFLATE:
            data = zlib.decompress(data)
        elif filt.id == LZF:
            # the bytes it was given: the chunk, with the checksums of any
            # fletcher32 filters that ran before it
            size = spec.chunk_nbytes + 4 * sum(spec.filters[j].id == FLETCHER32
                                               for j in active if j < i)
            data = native.lzf_decompress(data, size)
        elif filt.id == SHUFFLE:
            size = filt.values[0] if filt.values else spec.dtype.itemsize
            if size > 1:
                data = _unshuffle(data, size)
    if len(data) != spec.chunk_nbytes:
        raise UnsupportedHDF5(f"a chunk decoded to {len(data)} bytes, not "
                              f"{spec.chunk_nbytes}")
    return data


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
