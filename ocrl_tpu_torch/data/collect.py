"""Dataset collection from the synthetic envs into OCRL HDF5 files
(counterpart of ocrl_tpu/data/collect.py, on the port's envs and without
h5py).

The file holds groups ``TrainingSet`` and ``ValidationSet``, each with
``obss`` (uint8 NHWC) and ``num_objs`` (int64), and optionally ``masks``
(uint8 [n, K, H, W, 1]), ``labels`` (int64, the quadrant of the target
object's centre) and ``objs`` (float32, the objects' state rows). The
splits are seeded ``seed`` and ``seed + 10_000``; within a split, worker r
of the chunk that starts at row ``written`` builds its env with seed
``seed0 + written + r``, so the arrays equal JAX's for the same config and
seed, bitwise, whatever ``num_proc``.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
from pathlib import Path

import numpy as np

from .. import native
from ..envs import make_env
from .hdf5_format import create


def canonical_filename(env_cfg, num_tr: int, num_val: int, seed: int) -> str:
    """The file name of ocrl_tpu/data/collect.py:19-31 (the reference's
    dataset registry names files so)."""
    n0, n1 = env_cfg.num_objects_range
    nrange = f"N{n0}" if n0 == n1 else f"N{n0}-{n1}"
    agent = "No" if env_cfg.agent_pos is None else (
        "".join(f"{int(p * 10):02d}"[:2] for p in env_cfg.agent_pos))
    return (
        f"{env_cfg.env}-{nrange}C{len(env_cfg.COLORS)}S{len(env_cfg.SHAPES)}"
        f"S{len(env_cfg.SCALES)}-{env_cfg.mode}Mode-AgentPos{agent}"
        f"-WoAgent{env_cfg.wo_agent}-Occlusion{env_cfg.occlusion}"
        f"-Skewed{env_cfg.skewed}-Seed{seed}-Tr{num_tr}-Val{num_val}.hdf5"
    )


def _collect_worker(args) -> dict[str, np.ndarray]:
    """``count`` observations of one env seeded ``seed`` (numpy and the
    rasterizer only: no torch, no CUDA)."""
    env_cfg, seed, count, only_initial, with_masks, with_labels, with_states = args
    env = make_env(env_cfg, seed)
    action_rng = np.random.default_rng(seed)
    obss = np.empty((count, env_cfg.obs_size, env_cfg.obs_size, env_cfg.obs_channels),
                    dtype=np.uint8)
    num_objs = np.empty((count,), dtype=np.int64)
    masks = None
    labels = np.empty((count,), dtype=np.int64) if with_labels else None
    objs = None
    if with_states:
        objs = np.empty((count, env_cfg.num_objects_range[1], env_cfg.state_size),
                        dtype=np.float32)
    obs = env.reset()
    for i in range(count):
        if only_initial:
            obs = env.reset()
        else:
            obs, _, done, _ = env.step(env.action_space.sample(action_rng))
            if done:
                obs = env.reset()
        obss[i] = obs
        num_objs[i] = env._num_objects
        if with_masks:
            m = env.render("mask")
            if masks is None:
                masks = np.empty((count,) + m.shape, dtype=np.uint8)
            masks[i] = m.astype(np.uint8)
        if with_labels:
            # the image quadrant of the target object's centre: a label one
            # can read off the pixels (ocrl_tpu/data/collect.py:71-82)
            state = env.render("state", fill_empty=True)
            tx, ty = state[env._target_obj_idx][-2:]
            labels[i] = int(ty > 0.5) * 2 + int(tx > 0.5)
        if with_states:
            state = env.render("state", fill_empty=True)
            objs[i] = state[: env_cfg.num_objects_range[1]]
    out = {"obss": obss, "num_objs": num_objs}
    if masks is not None:
        out["masks"] = masks
    if labels is not None:
        out["labels"] = labels
    if objs is not None:
        out["objs"] = objs
    return out


def collect_chunks(env_cfg, splits, num_proc, chunk_size, flags):
    """(split, first row, rows, their arrays) of each chunk in file order:
    ``splits`` holds (split, total, seed0) and ``flags`` (only_initial,
    with_masks, with_labels, with_states)."""
    for split, total, seed0 in splits:
        written = 0
        while written < total:
            n = min(chunk_size, total - written)
            per = [n // num_proc + (1 if r < n % num_proc else 0) for r in range(num_proc)]
            jobs = [(env_cfg, seed0 + written + r, c) + flags
                    for r, c in enumerate(per) if c > 0]
            if num_proc > 1 and len(jobs) > 1:
                # Forked, as JAX's collector: a caller may have CUDA up (chip_smoke.py
                # collects after it used the card), and a worker runs only the env
                # (numpy) and the rasterizer (ctypes), never torch or CUDA; torch's
                # fork handler marks CUDA unusable in the child. The rasterizer is
                # built in the parent first, not by each worker.
                with mp.get_context("fork").Pool(len(jobs)) as pool:
                    parts = pool.map(_collect_worker, jobs)
            else:
                parts = [_collect_worker(j) for j in jobs]
            yield split, written, n, {k: np.concatenate([p[k] for p in parts])
                                      for k in parts[0]}
            written += n


def collect_dataset(env_cfg, num_tr: int, num_val: int, num_proc: int = 1,
                    only_initial: bool = True, seed: int = 0,
                    chunk_size: int = 100000, with_masks: bool = False,
                    with_labels: bool = False, with_states: bool = False,
                    out_file: str | Path | None = None,
                    out_dir: str | Path = "datasets") -> Path:
    """Collect the observations and write the HDF5 file; returns its path
    (``out_file``, else ``<out_dir>/<canonical_filename>``).

    The file is laid out once the first chunk shows each array's row shape
    and dtype, and every chunk is then written at its rows' offsets. With
    ``only_initial`` (the config's default) each observation is a fresh
    reset; else the env steps on uniform actions drawn from a generator
    seeded as the env (JAX draws them from gymnasium's unseeded space, so
    only the default path can equal JAX's)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if out_file is None:
        out_file = out_dir / canonical_filename(env_cfg, num_tr, num_val, seed)
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    native.build()
    splits = (("TrainingSet", num_tr, seed), ("ValidationSet", num_val, seed + 10_000))
    chunks = collect_chunks(env_cfg, splits, num_proc, chunk_size,
                            (only_initial, with_masks, with_labels, with_states))
    first = next(chunks, None)
    rows = {} if first is None else {k: (v.shape[1:], v.dtype) for k, v in first[3].items()}
    offsets = create(out_file, {split: {k: ((total,) + shape, dtype)
                                        for k, (shape, dtype) in rows.items()}
                                if total else {}
                                for split, total, _ in splits})
    with open(out_file, "r+b") as f:
        for split, written, _, arrays in itertools.chain([first] if first else [], chunks):
            for key, arr in arrays.items():
                f.seek(offsets[split][key] + written * arr[0].nbytes)
                f.write(np.ascontiguousarray(arr).tobytes())
    return out_file
