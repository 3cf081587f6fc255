"""The dataset loader of the port (counterpart of ocrl_tpu/data/hdf5.py):
a split of an OCRL HDF5 file, and a batch iterator with JAX's chunk
shuffle, draw for draw.

``read_slice`` returns, byte for byte, what JAX's returns (h5py's
``group[key][start:stop]``, then ``_postprocess``) for every layout
``hdf5_format.read_layout`` reads: contiguous datasets as ``np.memmap``
views (as JAX serves them), compact ones from the bytes in their header,
chunked ones assembled from their decoded chunks (``ChunkRows``). A file
outside what ``read_layout`` reads raises, as there is no h5py to fall
back on. Batches are numpy on the host: ``obss`` as stored (uint8 NHWC),
``labels`` int32 [n, -1], every other key (masks, objs) float32; the
``num_objs`` dataset is not served.
"""

from __future__ import annotations

import itertools
import os
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .hdf5_format import Chunked, Compact, decode_chunk, read_layout


class ChunkRows:
    """Rows of a chunked dataset, assembled from its chunks.

    A read of rows [start, stop) decodes every chunk of the chunk rows it
    touches (a chunk row: the ``chunks[0]`` dataset rows that one chunk
    coordinate along dimension 0 covers, across every other dimension),
    each chunk once; chunks never written read as the fill value. The
    decoded last chunk row of a read is kept for the next one, so that
    consecutive reads inside one chunk row (batches of 32 in chunk rows of
    75) decode it once: the cache holds at most one chunk row,
    ``chunks[0]`` x the bytes of one dataset row. Callers serialise reads
    (``H5Dataset`` holds a lock); the file is read with ``os.pread``."""

    def __init__(self, fd: int, spec: Chunked):
        self.fd, self.spec = fd, spec
        self.slot = np.full(spec.grid, -1, np.int64)
        if len(spec.coords):
            self.slot[tuple(spec.coords.T)] = np.arange(len(spec.coords))
        self.fill = np.frombuffer(spec.fill, spec.dtype)[0]
        self.cached: tuple[int, np.ndarray] | None = None

    def chunk_row(self, c0: int) -> np.ndarray:
        spec, ch0 = self.spec, self.spec.chunks[0]
        rows = min(ch0, spec.shape[0] - c0 * ch0)
        out = np.empty((rows,) + spec.shape[1:], spec.dtype)
        for rest in itertools.product(*(range(g) for g in spec.grid[1:])):
            where = (slice(None),) + tuple(slice(c * n, min((c + 1) * n, dim)) for c, n, dim in
                                           zip(rest, spec.chunks[1:], spec.shape[1:]))
            i = self.slot[(c0,) + rest]
            if i < 0:
                out[where] = self.fill
                continue
            raw = os.pread(self.fd, int(spec.sizes[i]), int(spec.offsets[i]))
            chunk = np.frombuffer(decode_chunk(spec, raw, int(spec.masks[i])),
                                  spec.dtype).reshape(spec.chunks)
            out[where] = chunk[(slice(0, rows),) + tuple(slice(0, w.stop - w.start)
                                                          for w in where[1:])]
        return out

    def read(self, start: int, stop: int) -> np.ndarray:
        spec, ch0 = self.spec, self.spec.chunks[0]
        start, stop = min(start, spec.shape[0]), min(stop, spec.shape[0])
        out = np.empty((max(stop - start, 0),) + spec.shape[1:], spec.dtype)
        if stop <= start:
            return out
        for c0 in range(start // ch0, (stop - 1) // ch0 + 1):
            if self.cached is not None and self.cached[0] == c0:
                rows = self.cached[1]
            else:
                rows = self.chunk_row(c0)
                self.cached = (c0, rows)
            lo, hi = max(start, c0 * ch0), min(stop, (c0 + 1) * ch0)
            out[lo - start:hi - start] = rows[lo - c0 * ch0:hi - c0 * ch0]
        return out

    def __getitem__(self, rows: slice) -> np.ndarray:
        start, stop, _ = rows.indices(self.spec.shape[0])
        return self.read(start, stop)


def open_rows(path: str, spec, fd: Optional[int]):
    """What serves ``[start:stop]`` rows of a dataset of ``read_layout``'s
    ``spec``: an ``np.memmap`` (contiguous), the bytes of its header
    (compact) or a ``ChunkRows`` reading ``fd`` (chunked)."""
    if isinstance(spec, Chunked):
        return ChunkRows(fd, spec)
    if isinstance(spec, Compact):
        return spec.array()
    offset, shape, dtype = spec
    if offset is None:
        raise ValueError(f"{path}: a contiguous dataset with no data written")
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)


class H5Dataset:
    """A split ("TrainingSet" / "ValidationSet") of an OCRL HDF5 file."""

    def __init__(self, path: str | Path, split: str):
        self.path = str(path)
        layout = read_layout(self.path)
        if split not in layout:
            raise KeyError(f"{self.path} has no group '{split}' (groups: {list(layout)})")
        spec = layout[split]
        self.keys = [k for k in spec if k != "num_objs"]
        for key in self.keys:
            if isinstance(spec[key], tuple) and spec[key][0] is None:
                raise ValueError(f"{self.path}: '{split}/{key}' has no data written")
        obss = spec["obss"]
        self.num_samples = (obss[1] if isinstance(obss, tuple) else obss.shape)[0]
        self._spec = {k: spec[k] for k in self.keys}
        self._rows: Optional[dict] = None
        self._fd: Optional[int] = None
        self._lock = threading.Lock()

    def _open(self) -> dict:
        if self._rows is None:
            if any(isinstance(spec, Chunked) for spec in self._spec.values()):
                self._fd = os.open(self.path, os.O_RDONLY)
            self._rows = {key: open_rows(self.path, spec, self._fd)
                          for key, spec in self._spec.items()}
        return self._rows

    def __len__(self) -> int:
        return self.num_samples

    def __del__(self):
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)

    def read_slice(self, start: int, stop: int) -> dict[str, np.ndarray]:
        # memmap slices are views: the shuffle gathers from them, so the bytes
        # are copied once; chunked rows are decoded under the lock (zlib and
        # the LZF decoder release the GIL, so the prefetch thread's decode
        # overlaps the step)
        with self._lock:
            rows = self._open()
            raw = {k: rows[k][start:stop] for k in self.keys}
        return _postprocess(raw)


def read_array(path: str | Path, spec) -> np.ndarray:
    """A whole dataset of ``read_layout``'s ``spec``, as h5py's ``dataset[()]``
    gives it."""
    fd = os.open(path, os.O_RDONLY)
    try:
        return np.array(open_rows(str(path), spec, fd)[:])
    finally:
        os.close(fd)


def _postprocess(raw: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """obss uint8 as stored (the step divides by 255 on the device), labels
    int32 [n, -1], the rest float32 (ocrl_tpu/data/hdf5.py:97-114)."""
    out = {}
    for key, value in raw.items():
        if key == "obss":
            out[key] = np.asarray(value)
        elif key == "labels":
            out[key] = np.asarray(value, dtype=np.int32).reshape(len(value), -1)
        else:
            out[key] = np.asarray(value, dtype=np.float32)
    return out


class DataLoader:
    """Chunk-shuffled batches of an H5Dataset (ocrl_tpu/data/hdf5.py:117-168).

    Shuffled: each pass draws from ``default_rng(seed + epoch)``, the epoch
    being this loader's count of passes from 0: the chunk order, then a
    permutation within each chunk; rows left over at a chunk's end lead the
    next one, and the last partial batch is dropped. Unshuffled (validation):
    in file order, the last partial batch kept.
    """

    def __init__(self, dataset: H5Dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, chunk_size: int = 4096):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.chunk_size = max(chunk_size, batch_size)
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.shuffle else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.dataset)
        if not self.shuffle:
            for start in range(0, n, self.batch_size):
                yield self.dataset.read_slice(start, min(start + self.batch_size, n))
            return

        rng = np.random.default_rng(self._seed + self._epoch)
        self._epoch += 1
        chunk_starts = np.arange(0, n, self.chunk_size)
        rng.shuffle(chunk_starts)
        leftover: Optional[dict[str, np.ndarray]] = None
        for start in chunk_starts:
            stop = min(start + self.chunk_size, n)
            chunk = self.dataset.read_slice(start, stop)
            perm = rng.permutation(stop - start)
            chunk = {k: v[perm] for k, v in chunk.items()}
            if leftover is not None:
                chunk = {k: np.concatenate([leftover[k], chunk[k]]) for k in chunk}
                leftover = None
            size = len(next(iter(chunk.values())))
            full = size - size % self.batch_size
            for i in range(0, full, self.batch_size):
                yield {k: v[i:i + self.batch_size] for k, v in chunk.items()}
            if full < size:
                leftover = {k: v[full:] for k, v in chunk.items()}


def resolve_datafile(dataset_config, repo_root: Optional[Path] = None) -> Path:
    """The dataset file: ``datadir`` as given or under ``repo_root`` (the
    working directory), else ``<repo_root>/<dataset_dir>/<dataset_checkpoint.file>``
    (ocrl_tpu/data/hdf5.py:171-190). Nothing is downloaded."""
    repo_root = repo_root or Path.cwd()
    candidates = []
    if dataset_config.datadir:
        candidates += [Path(dataset_config.datadir), repo_root / dataset_config.datadir]
    if dataset_config.dataset_checkpoint.file:
        candidates.append(repo_root / (dataset_config.dataset_dir or "datasets")
                          / dataset_config.dataset_checkpoint.file)
    for cand in candidates:
        if cand.is_file():
            return cand
    raise FileNotFoundError(
        f"Dataset file not found (tried {[str(c) for c in candidates]}). Collect it with: "
        "python -m ocrl_tpu_torch.collect_dataset_from_synthetic_envs env=<env>")


def get_dataloaders(dataset_config, batch_size: int, num_workers: int = 0,
                    seed: int = 0) -> tuple[DataLoader, DataLoader]:
    """(train, val): the shuffled TrainingSet and the ValidationSet in order.
    ``num_workers`` is taken for the reference's signature and unused, as
    in JAX (the prefetch thread overlaps the reads)."""
    datafile = resolve_datafile(dataset_config)
    return (DataLoader(H5Dataset(datafile, "TrainingSet"), batch_size, shuffle=True,
                       seed=seed),
            DataLoader(H5Dataset(datafile, "ValidationSet"), batch_size, shuffle=False))
