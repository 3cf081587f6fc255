"""The port's HDF5 reader (``data.hdf5_format``, ``data.hdf5``) on every
layout h5py writes through ``create_dataset``'s own arguments, against
JAX's ``H5Dataset`` (h5py underneath) on the CPU:

- each layout, in a tiny file written by h5py 3 (``LAYOUTS``): the chunk
  index it gets, ``read_slice`` bitwise JAX's over ranges that cross chunk
  edges and partial edge chunks, and the loader's batches, shuffled and in
  order, over two epochs;
- a paged extensible array (over 131 k chunks), chunks never written, a
  corrupted fletcher32 chunk and a corrupted object header;
- each refused filter, layout, link and datatype raises by name;
- the LZF decoder against h5py's LZF filter;
- the committed fixtures under tests/data/hdf5 against their manifest.

Chunk shapes are chosen so that every dimension has a partial edge chunk.
"""

import hashlib
import json
from pathlib import Path

import h5py
import numpy as np
import pytest
from h5py import h5d, h5p, h5s, h5t, h5z

from ocrl_tpu.data import hdf5 as jhdf5

from ocrl_tpu_torch import native
from ocrl_tpu_torch.data import hdf5 as thdf5
from ocrl_tpu_torch.data import hdf5_format as hf

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "hdf5"
ROWS = 40
CHUNKS = {"obss": (6, 4, 8, 2), "masks": (7, 2, 8, 4, 1), "labels": (9,), "objs": (5, 2, 3)}
# objs in chunks of one element: 1200 chunks, deeper than one B-tree node
# and more than one fixed-array page
TINY = {"objs": (1, 1, 1)}


def arrays(rows: int = ROWS, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"obss": rng.integers(0, 8, (rows, 8, 8, 3), dtype=np.uint8) * 30,
            "masks": (rng.random((rows, 3, 8, 8, 1)) < 0.3).astype(np.uint8),
            "labels": rng.integers(0, 4, (rows,)).astype(np.int64),
            "objs": rng.random((rows, 6, 5), dtype=np.float32)}


def lowlevel(group, name: str, array: np.ndarray, chunks=None, compact=False,
             early=False) -> None:
    """A dataset made through h5py's low-level API: a compact layout, or
    chunks allocated at creation (the implicit index)."""
    dcpl = h5p.create(h5p.DATASET_CREATE)
    if compact:
        dcpl.set_layout(h5d.COMPACT)
    if chunks:
        dcpl.set_chunk(chunks)
    if early:
        dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
    dsid = h5d.create(group.id, name.encode(), h5t.py_create(array.dtype),
                      h5s.create_simple(array.shape), dcpl=dcpl)
    dsid.write(h5s.ALL, h5s.ALL, np.ascontiguousarray(array))


def maxshape(shape, unlimited):
    return tuple(None if d in unlimited else n for d, n in enumerate(shape))


# name -> (h5py.File arguments, create_dataset arguments for every key, or a
# callable writing the group; the chunk index expected for obss)
LAYOUTS = {
    "contiguous": ({}, {}, None),
    "chunked": ({}, dict(chunks=CHUNKS, tiny=True), "version-1 B-tree"),
    "gzip-shuffle": ({}, dict(chunks=CHUNKS, compression="gzip", shuffle=True),
                     "version-1 B-tree"),
    "lzf-fletcher32": ({}, dict(chunks=CHUNKS, compression="lzf", fletcher32=True),
                       "version-1 B-tree"),
    "lzf-incompressible": ({}, dict(chunks=CHUNKS, compression="lzf", random=True),
                           "version-1 B-tree"),
    "big-endian": ({}, dict(chunks=CHUNKS, compression="gzip", order=">"), "version-1 B-tree"),
    "float16": ({}, dict(f16=True), None),
    "userblock": (dict(userblock_size=512), dict(chunks=CHUNKS, compression="gzip"),
                  "version-1 B-tree"),
    "compact": ({}, "compact", None),
    "track-order": ({}, dict(track_order=True), None),
    "track-order-chunked": ({}, dict(track_order=True, chunks=CHUNKS, compression="lzf"),
                            "version-1 B-tree"),
    "latest-contiguous": (dict(libver="latest"), {}, None),
    "latest-fixed-array": (dict(libver="latest"), dict(chunks=CHUNKS, compression="gzip"),
                           "fixed array"),
    "latest-fixed-array-paged": (dict(libver="latest"), dict(chunks=CHUNKS, tiny=True),
                                 "fixed array"),
    "latest-fixed-array-max": (dict(libver="latest"), dict(chunks=CHUNKS, grow=True,
                                                           compression="gzip"), "fixed array"),
    "latest-extensible-array": (dict(libver="latest"), dict(chunks=CHUNKS, unlimited=(0,)),
                                "extensible array"),
    "latest-extensible-array-filtered": (
        dict(libver="latest"), dict(chunks=CHUNKS, unlimited=(0,), compression="gzip",
                                    shuffle=True, fletcher32=True), "extensible array"),
    # a collector appending episodes while a reader trains: SWMR mode, which
    # needs libver="latest"
    "latest-swmr-append": (dict(libver="latest"), dict(chunks=CHUNKS, compression="gzip",
                                                       swmr=True), "extensible array"),
    "latest-extensible-array-dim1": (dict(libver="latest"), dict(chunks=CHUNKS, unlimited=(1,)),
                                     "extensible array"),
    "latest-btree2": (dict(libver="latest"), dict(chunks=CHUNKS, unlimited=(0, 1), tiny=True),
                      "version-2 B-tree"),
    "latest-btree2-filtered": (dict(libver="latest"),
                               dict(chunks=CHUNKS, unlimited=(0, 1), compression="lzf",
                                    fletcher32=True, tiny=True), "version-2 B-tree"),
    "latest-single-chunk": (dict(libver="latest"), dict(chunks="whole"), "single chunk"),
    "latest-single-chunk-gzip": (dict(libver="latest"), dict(chunks="whole", compression="gzip"),
                                 "single chunk"),
    "latest-implicit": (dict(libver="latest"), "implicit", "implicit"),
    "latest-dense-links": (dict(libver="latest"), dict(extra=8), None),
    "latest-dense-links-indirect": (dict(libver="latest"), dict(extra=80, chunks=CHUNKS,
                                                                compression="gzip"),
                                    "fixed array"),
    "latest-track-order": (dict(libver="latest"), dict(track_order=True, extra=12,
                                                       chunks=CHUNKS, unlimited=(0,)),
                           "extensible array"),
}


# what each layout's file must hold (or lack): the version-2 object header,
# the fractal heap and name B-tree of dense links, an indirect heap block
MARKS = {"track-order": ([b"OHDR"], [b"FRHP"]), "latest-contiguous": ([b"OHDR"], [b"FRHP"]),
         "latest-dense-links": ([b"FRHP", b"BTHD"], [b"FHIB"]),
         "latest-dense-links-indirect": ([b"FRHP", b"FHIB"], []),
         "latest-track-order": ([b"FRHP", b"EAHD"], []), "chunked": ([], [b"OHDR"])}


def write_layout(name: str, path: Path, data: dict) -> None:
    file_kw, how, _ = LAYOUTS[name]
    with h5py.File(path, "w", **file_kw) as f:
        opts = dict(how) if isinstance(how, dict) else {}
        track = opts.pop("track_order", None)
        group = f.create_group("TrainingSet", track_order=track)
        extra = opts.pop("extra", 0)
        chunks = opts.pop("chunks", None)
        tiny, grow = opts.pop("tiny", False), opts.pop("grow", False)
        unlimited, order = opts.pop("unlimited", ()), opts.pop("order", "<")
        random, f16 = opts.pop("random", False), opts.pop("f16", False)
        swmr, appended = opts.pop("swmr", False), {}
        for key, array in data.items():
            if random and key == "obss":
                array = np.random.default_rng(1).integers(0, 256, array.shape, dtype=np.uint8)
            if order == ">" and key in ("labels", "objs"):
                array = array.astype(array.dtype.newbyteorder(">"))
            if f16 and key == "objs":
                array = array.astype(">f2")
            if how == "compact":
                lowlevel(group, key, array, compact=True)
                continue
            if how == "implicit":
                lowlevel(group, key, array, chunks=CHUNKS[key], early=True)
                continue
            kw = dict(opts)
            if swmr:
                appended[key] = group.create_dataset(
                    key, shape=(0,) + array.shape[1:], maxshape=(None,) + array.shape[1:],
                    dtype=array.dtype, chunks=chunks[key], **kw)
                continue
            if chunks == "whole":
                kw["chunks"] = array.shape
            elif chunks:
                kw["chunks"] = TINY.get(key, chunks[key]) if tiny else chunks[key]
            if unlimited:
                kw["maxshape"] = maxshape(array.shape, unlimited)
            if grow:
                kw["maxshape"] = (2 * len(array),) + array.shape[1:]
            group.create_dataset(key, data=array, track_order=track, **kw)
        if swmr:
            f.swmr_mode = True
            for start in range(0, ROWS, 7):
                for key, d in appended.items():
                    d.resize((min(start + 7, ROWS),) + d.shape[1:])
                    d[start:start + 7] = data[key][start:start + 7]
                    d.flush()
        for i in range(extra):
            group.create_dataset(f"an_extra_dataset_with_a_long_name_{i:03d}",
                                 data=np.arange(ROWS) + i)


@pytest.fixture(scope="module")
def layout_files(tmp_path_factory):
    """Every layout's file, written once: {name: (path, arrays written)}."""
    root = tmp_path_factory.mktemp("layouts")
    out = {}
    for name in LAYOUTS:
        data = arrays()
        write_layout(name, root / f"{name}.h5", data)
        out[name] = root / f"{name}.h5"
    return out


def assert_same(got: dict, want: dict, where) -> None:
    assert set(got) == set(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (where, k)
        assert got[k].tobytes() == want[k].tobytes(), (where, k)


# ranges: whole, edges of 6-row chunks, one row, a partial last chunk, past
# the end
RANGES = [(0, ROWS), (5, 7), (6, 12), (11, 25), (17, 18), (35, ROWS), (36, 60)]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_reads_as_h5py_reads_it(layout_files, name):
    """read_slice bitwise JAX's (h5py's slice and _postprocess) over
    ranges crossing chunk edges; the whole of every dataset as h5py's
    ``[()]``; the chunk index the layout gets."""
    path = layout_files[name]
    spec = hf.read_layout(path)["TrainingSet"]
    expected = LAYOUTS[name][2]
    got_index = spec["obss"].index if isinstance(spec["obss"], hf.Chunked) else None
    assert got_index == expected
    raw = path.read_bytes()
    superblock = raw.index(b"\x89HDF")
    assert raw[superblock + 8] == (3 if name.startswith("latest") else 0)
    assert superblock == (512 if name == "userblock" else 0)
    present, absent = MARKS.get(name, ([], []))
    assert all(m in raw for m in present) and not any(m in raw for m in absent)
    if name == "lzf-incompressible":                # LZF gave up: stored as they are
        assert spec["obss"].masks.any() and not spec["masks"].masks.any()
    port, ref = thdf5.H5Dataset(path, "TrainingSet"), jhdf5.H5Dataset(path, "TrainingSet")
    for start, stop in RANGES:
        assert_same(port.read_slice(start, stop), ref.read_slice(start, stop), (start, stop))
    with h5py.File(path, "r") as f:
        for key, s in spec.items():
            want = f["TrainingSet"][key][()]
            got = thdf5.read_array(path, s)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_loader_gives_jax_batches(layout_files, name):
    """The loader over each layout: two passes, shuffled (chunks of 16
    rows, across the file's chunk rows) and in order, as JAX's."""
    path = layout_files[name]
    for shuffle in (True, False):
        jl = jhdf5.DataLoader(jhdf5.H5Dataset(path, "TrainingSet"), 6, shuffle=shuffle, seed=3,
                              chunk_size=16)
        tl = thdf5.DataLoader(thdf5.H5Dataset(path, "TrainingSet"), 6, shuffle=shuffle, seed=3,
                              chunk_size=16)
        for _ in range(2):
            want, got = list(jl), list(tl)
            assert len(got) == len(want) > 0
            for i, (g, w) in enumerate(zip(got, want)):
                assert_same(g, w, (shuffle, i))


def test_chunk_rows_are_decoded_once_and_kept(layout_files, monkeypatch):
    """Consecutive reads inside one chunk row decode it once (the cache
    keeps the last chunk row); a read across two rows decodes the new one."""
    decoded = []

    def counted(spec, raw, mask):
        decoded.append(spec)
        return hf.decode_chunk(spec, raw, mask)

    monkeypatch.setattr(thdf5, "decode_chunk", counted)
    path = layout_files["gzip-shuffle"]
    obss = hf.read_layout(path)["TrainingSet"]["obss"]
    dataset = thdf5.H5Dataset(path, "TrainingSet")

    def count() -> int:                         # obss's chunks (no other key has its shape)
        return sum(spec.shape == obss.shape for spec in decoded)

    per_row = int(np.prod(obss.grid[1:]))
    dataset.read_slice(0, 2)
    assert count() == per_row
    dataset.read_slice(2, 6)
    assert count() == per_row
    dataset.read_slice(4, 8)
    assert count() == 2 * per_row


def test_paged_extensible_array_reads_as_h5py(tmp_path):
    """An extensible array past its first paged data block (super block 13:
    elements from 131060 on), resized past what was written."""
    path = tmp_path / "paged.h5"
    data = (np.arange(34000 * 4) % 251).astype(np.uint8).reshape(34000, 4, 1, 1)
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_group("TrainingSet").create_dataset("obss", data=data, chunks=(1, 1, 1, 1),
                                                         maxshape=(None, 4, 1, 1))
        d.resize((34100, 4, 1, 1))
    spec = hf.read_layout(path)["TrainingSet"]["obss"]
    assert spec.index == "extensible array" and len(spec.offsets) == 34000 * 4
    port, ref = thdf5.H5Dataset(path, "TrainingSet"), jhdf5.H5Dataset(path, "TrainingSet")
    for start, stop in [(0, 3), (32760, 32770), (33990, 34010), (34090, 34100)]:
        assert_same(port.read_slice(start, stop), ref.read_slice(start, stop), (start, stop))


@pytest.mark.parametrize("index", ["version-1 B-tree", "extensible array", "version-2 B-tree"])
def test_chunks_never_written_read_as_the_fill_value(tmp_path, index):
    """A resizable dataset filled only in part: its chunks never written read
    as the dataset's fill value, as h5py reads them."""
    path = tmp_path / "part.h5"
    unlimited = {"version-1 B-tree": (0,), "extensible array": (0,),
                 "version-2 B-tree": (0, 1)}[index]
    libver = None if index == "version-1 B-tree" else "latest"
    data = arrays()
    with h5py.File(path, "w", **({"libver": libver} if libver else {})) as f:
        group = f.create_group("TrainingSet")
        for key, array in data.items():
            d = group.create_dataset(key, shape=(0,) + array.shape[1:], dtype=array.dtype,
                                     chunks=CHUNKS[key], fillvalue=7,
                                     maxshape=maxshape(array.shape, unlimited))
            d.resize((ROWS,) + array.shape[1:])
            d[:13] = array[:13]
            d[30:32] = array[30:32]
    spec = hf.read_layout(path)["TrainingSet"]["obss"]
    assert spec.index == index
    assert len(spec.offsets) < int(np.prod(spec.grid))
    port, ref = thdf5.H5Dataset(path, "TrainingSet"), jhdf5.H5Dataset(path, "TrainingSet")
    got = port.read_slice(0, ROWS)
    assert_same(got, ref.read_slice(0, ROWS), index)
    assert (got["obss"][18:24] == 7).all() and (got["objs"][35:] == 7).all()


@pytest.mark.parametrize("part", ["fletcher32 chunk", "object header"])
def test_a_corrupted_checksum_raises(tmp_path, part):
    """A flipped byte in a fletcher32 chunk, or in the checksum of a
    version-2 object header, raises HDF5ChecksumError (an OSError); h5py
    raises too (an OSError for the chunk's failed filter, a KeyError naming
    the checksum for the header)."""
    path = tmp_path / "bad.h5"
    if part == "fletcher32 chunk":
        write_layout("lzf-fletcher32", path, arrays())
    else:
        with h5py.File(path, "w", libver="latest") as f:
            f.create_group("TrainingSet").create_dataset("obss", data=arrays()["obss"])
    raw = bytearray(path.read_bytes())
    if part == "fletcher32 chunk":
        spec = hf.read_layout(path)["TrainingSet"]["obss"]
        raw[int(spec.offsets[3]) + 1] ^= 0x01
    else:                                       # the checksum of obss's header, the last one
        at = raw.rindex(b"OHDR")
        flags = raw[at + 5]
        at += 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 0x03)
        raw[at + width + int.from_bytes(raw[at:at + width], "little")] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError if part == "fletcher32 chunk" else KeyError,
                       match="filter returned failure" if part == "fletcher32 chunk"
                       else "checksum"):
        h5py.File(path, "r")["TrainingSet"]["obss"][()]
    with pytest.raises(hf.HDF5ChecksumError, match="fletcher32" if part == "fletcher32 chunk"
                       else "object header"):
        thdf5.H5Dataset(path, "TrainingSet").read_slice(0, ROWS)


def _refused(kind: str):
    """(writer of the group, what the refusal names)."""
    obss = arrays()["obss"]
    return {
        "szip": (lambda g: g.create_dataset("obss", data=obss, compression="szip"), "szip"),
        "nbit": (lambda g: _filtered(g, obss, h5z.FILTER_NBIT, 0), "nbit"),
        "scaleoffset": (lambda g: g.create_dataset("obss", data=obss, scaleoffset=0),
                        "scaleoffset"),
        "plugin filter": (lambda g: _filtered(g, obss, 32001, h5z.FLAG_OPTIONAL),
                          "plugin filter 32001"),             # blosc's id; not installed
        "external storage": (lambda g: g.create_dataset(
            "obss", data=obss, external=[(str(g.file.filename) + ".raw", 0,
                                          h5py.h5f.UNLIMITED)]), "external files"),
        "virtual": (lambda g: _virtual(g, obss), "virtual"),
        "soft link": (lambda g: g.__setitem__("obss", h5py.SoftLink("/elsewhere")),
                      "soft link"),
        "external link": (lambda g: g.__setitem__("obss", h5py.ExternalLink("o.h5", "/x")),
                          "external link"),
        "string": (lambda g: g.create_dataset("obss", data=np.array([b"ab", b"cd"])),
                   "class string"),
        "variable-length": (lambda g: g.create_dataset(
            "obss", data=np.array(["a", "bb"], dtype=object), dtype=h5py.string_dtype()),
            "class variable-length"),
        "compound": (lambda g: g.create_dataset("obss", data=np.zeros(3, [("a", "<i4"),
                                                                          ("b", "<f4")])),
                     "class compound"),
        "enum": (lambda g: g.create_dataset("obss", data=np.zeros(3, bool)), "class enumerated"),
    }[kind]


def _filtered(group, obss, filter_id: int, flags: int):
    dcpl = h5p.create(h5p.DATASET_CREATE)
    dcpl.set_chunk(CHUNKS["obss"])
    dcpl.set_filter(filter_id, flags)
    dsid = h5d.create(group.id, b"obss", h5t.py_create(obss.dtype),
                      h5s.create_simple(obss.shape), dcpl=dcpl)
    dsid.write(h5s.ALL, h5s.ALL, obss)


def _virtual(group, obss):
    source = group.file.create_dataset("source", data=obss)
    layout = h5py.VirtualLayout(obss.shape, obss.dtype)
    layout[:] = h5py.VirtualSource(source)
    group.create_virtual_dataset("obss", layout)


@pytest.mark.parametrize("kind", ["szip", "nbit", "scaleoffset", "plugin filter",
                                  "external storage", "virtual", "soft link", "external link",
                                  "string", "variable-length", "compound", "enum"])
def test_what_the_reader_refuses_raises_by_name(tmp_path, kind):
    path = tmp_path / "refused.h5"
    write, named = _refused(kind)
    with h5py.File(path, "w", libver="latest" if kind == "virtual" else "earliest") as f:
        write(f.create_group("TrainingSet"))
    with pytest.raises(hf.UnsupportedHDF5, match=named):
        hf.read_layout(path)
    with pytest.raises(hf.UnsupportedHDF5, match=named):
        thdf5.H5Dataset(path, "TrainingSet")


@pytest.mark.parametrize("data", ["random", "repetitive"])
def test_lzf_decoder_agrees_with_h5py(tmp_path, data):
    """Chunks that h5py's LZF filter compressed, read raw and decoded by the
    port's C++ decoder: random bytes of a small alphabet (literal runs and
    short references) and a tiled pattern (references of 9 bytes and more);
    a stream cut short raises."""
    rng = np.random.default_rng(5)
    if data == "random":
        array = rng.integers(0, 6, (64, 1024), dtype=np.uint8)
    else:
        array = np.tile(rng.integers(0, 256, (1, 300), dtype=np.uint8), (64, 4))[:, :1024]
    path = tmp_path / "lzf.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=array, chunks=(16, 1024), compression="lzf")
        chunks = [d.id.read_direct_chunk((i * 16, 0)) for i in range(4)]
    for i, (mask, raw) in enumerate(chunks):
        assert mask == 0 and len(raw) < array[16 * i:16 * (i + 1)].nbytes
        assert native.lzf_decompress(raw, 16 * 1024) == array[16 * i:16 * (i + 1)].tobytes()
    with pytest.raises(ValueError, match="LZF"):
        native.lzf_decompress(chunks[0][1][:-3], 16 * 1024)


def test_committed_fixtures_match_their_manifest():
    """Every dataset of every committed fixture, read by the port, has the
    shape, dtype and SHA-256 that h5py read when they were written."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert set(manifest["files"]) == {p.name for p in FIXTURES.glob("*.h5")}
    total = sum(p.stat().st_size for p in FIXTURES.glob("*.h5"))
    assert total < 4 * 2 ** 20
    for name, groups in manifest["files"].items():
        layout = hf.read_layout(FIXTURES / name)
        assert set(layout) == set(groups), name
        for group, datasets in groups.items():
            assert set(layout[group]) == set(datasets), (name, group)
            for key, want in datasets.items():
                got = thdf5.read_array(FIXTURES / name, layout[group][key])
                assert [list(got.shape), got.dtype.str] == [want["shape"], want["dtype"]]
                assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], \
                    (name, group, key)
