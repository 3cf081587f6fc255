"""The dataset loader of the port (counterpart of ocrl_tpu/data/hdf5.py):
a split of an OCRL HDF5 file served from ``np.memmap``, and a batch
iterator with JAX's chunk shuffle, draw for draw.

The port reads only the contiguous, uncompressed files the collectors
write (``hdf5_format``); any other file raises, as there is no h5py to fall
back on. Batches are numpy on the host: ``obss`` uint8 NHWC as stored,
``labels`` int32 [n, -1], every other key (masks, objs) float32; the
``num_objs`` dataset is not served.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .hdf5_format import read_layout


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
            if spec[key][0] is None:
                raise ValueError(f"{self.path}: '{split}/{key}' has no data written")
        self.num_samples = spec["obss"][1][0]
        self._spec = {k: spec[k] for k in self.keys}
        self._mmaps: Optional[dict[str, np.memmap]] = None

    def _mm(self) -> dict[str, np.memmap]:
        if self._mmaps is None:
            self._mmaps = {k: np.memmap(self.path, dtype=dt, mode="r", offset=off, shape=shape)
                           for k, (off, shape, dt) in self._spec.items()}
        return self._mmaps

    def __len__(self) -> int:
        return self.num_samples

    def read_slice(self, start: int, stop: int) -> dict[str, np.ndarray]:
        # memmap slices are views: the shuffle gathers from them, so the bytes
        # are copied once
        return _postprocess({k: m[start:stop] for k, m in self._mm().items()})


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
