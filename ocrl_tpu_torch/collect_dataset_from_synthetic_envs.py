"""Dataset collection entry point of the port (counterpart of the
repo-root collect_dataset_from_synthetic_envs.py):

    python -m ocrl_tpu_torch.collect_dataset_from_synthetic_envs \\
        env=random-N5C4S4S2 collection.num_tr=1000000 collection.num_val=10000 \\
        collection.with_masks=True collection.out_file=datasets/random.hdf5

Overrides as ``config.compose`` reads them over ``CollectConfig``:
``env=<file stem of configs/env>``, ``collection.*`` and ``run_dir``. The
run directory (``run_dir``, else outputs/dataset_collection/<env name>/<time>)
gets the config and run name; the file goes to ``collection.out_file``, else
``<collection.out_dir>/<canonical file name>``, and its path is printed.
Collection runs on the host (numpy and the rasterizer), not on the card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from .config import CollectConfig, compose
from .data.collect import collect_dataset
from .utils.logger import Run


def main(argv=None) -> Path:
    config = compose(CollectConfig(), sys.argv[1:] if argv is None else argv)
    run_dir = config.run_dir or (f"outputs/dataset_collection/{config.env.name}/"
                                 f"{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    Run(run_dir, f"CollectDataset-{config.env.name}", config)
    c = config.collection
    path = collect_dataset(config.env, num_tr=int(c.num_tr), num_val=int(c.num_val),
                           num_proc=int(c.num_proc), only_initial=bool(c.only_initial),
                           seed=int(c.seed), chunk_size=int(c.chunk_size),
                           with_masks=bool(c.with_masks), with_labels=bool(c.with_labels),
                           with_states=bool(c.with_states), out_file=c.out_file,
                           out_dir=c.out_dir)
    print(f"wrote {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
