"""CausalWorld dataset collection entry point of the port (counterpart of
the repo-root collect_dataset_from_cw_envs.py), on the fake TriFinger
backend:

    python -m ocrl_tpu_torch.collect_dataset_from_cw_envs \\
        --env cw-notarget-N4C11S1S1-hard --num-tr 1000000 --num-val 10000 \\
        --num-proc 50 --fake-sim --out datasets/cw.hdf5

JAX's flags and worker layout: each split is cut into ``--num-proc`` parts,
part i collected by an env seeded ``1000 * i`` (the validation split's
parts again from seed 0, as JAX's), random-action steps with a reset after
each done; ``obss`` (uint8, 64x64x3, or 64x64x9 for ``cw-fingerimg-*``),
``num_objs`` (``num_objects_range[0]``) and ``labels`` (the target's index,
``info["label"]``), both int64. The actions are uniform draws from a
generator seeded as the env (JAX draws them from gymnasium's unseeded
space). The workers are forked (numpy only); the file is written by
``data.hdf5_format.create`` in the layout h5py writes (no h5py). Without
``--fake-sim`` the env raises: causal_world is not ported.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
from pathlib import Path

import numpy as np

from .config import read_env_config, replace
from .data.hdf5_format import create
from .envs import make_env


def _worker(args) -> dict[str, np.ndarray]:
    """``count`` observations of the env seeded ``seed``."""
    env_cfg, seed, count = args
    env = make_env(env_cfg, seed)
    rng = np.random.default_rng(seed)
    obss = np.empty((count,) + env.observation_space.shape, np.uint8)
    labels = np.empty((count,), np.int64)
    env.reset()
    for i in range(count):
        obs, _, done, info = env.step(env.action_space.sample(rng))
        obss[i] = obs
        labels[i] = info.get("label", 0)
        if done:
            env.reset()
    return {"obss": obss, "num_objs": np.full((count,), env_cfg.num_objects_range[0], np.int64),
            "labels": labels}


def collect(env_cfg, num_tr: int, num_val: int, num_proc: int, out: str | Path) -> Path:
    """Collect both splits on ``num_proc`` forked workers and write ``out``."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    splits = {}
    for split, total in (("TrainingSet", num_tr), ("ValidationSet", num_val)):
        per = [total // num_proc + (1 if r < total % num_proc else 0) for r in range(num_proc)]
        jobs = [(env_cfg, 1000 * i, c) for i, c in enumerate(per) if c > 0]
        if len(jobs) > 1:
            with mp.get_context("fork").Pool(len(jobs)) as pool:
                parts = pool.map(_worker, jobs)
        else:
            parts = [_worker(j) for j in jobs]
        splits[split] = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    offsets = create(out, {split: {k: (v.shape, v.dtype) for k, v in arrays.items()}
                           for split, arrays in splits.items()})
    with open(out, "r+b") as f:
        for split, arrays in splits.items():
            for key, arr in arrays.items():
                f.seek(offsets[split][key])
                f.write(np.ascontiguousarray(arr).tobytes())
    return out


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--env", default="cw-notarget-N4C11S1S1-hard")
    parser.add_argument("--num-tr", type=int, default=1_000_000)
    parser.add_argument("--num-val", type=int, default=10_000)
    parser.add_argument("--num-proc", type=int, default=50)
    parser.add_argument("--out", default=None)
    parser.add_argument("--fake-sim", action="store_true",
                        help="use the kinematic fake TriFinger backend (the only one ported)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    env_cfg = read_env_config(args.env)
    if args.fake_sim:
        env_cfg = replace(env_cfg, "use_fake_sim", True)
    out = args.out or (f"datasets/{env_cfg.env}-N{env_cfg.num_objects_range[0]}"
                       f"-Tr{args.num_tr}-Val{args.num_val}.hdf5")
    path = collect(env_cfg, args.num_tr, args.num_val, args.num_proc, out)
    print(f"wrote {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
