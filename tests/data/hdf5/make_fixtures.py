"""Write the HDF5 fixtures of this directory with h5py, and their manifest.

    python tests/data/hdf5/make_fixtures.py      # from the root of a checkout

The images are rendered by the port's collector for random-N5C4S4S2
(64x64x3, 5 objects, masks on; seed 0): 240 training and 256 validation
images. Each fixture stores them in one layout of HDF5 that h5py writes
through ``create_dataset``'s own arguments, so that the port's reader,
which runs where h5py is not installed, can be held to what h5py read:

- eval-gzip.h5: both splits, gzip and shuffle at h5py's automatic chunks,
  superblock 0 (a version-1 B-tree chunk index);
- lzf-fletcher32.h5: LZF and fletcher32;
- latest-extensible.h5: libver "latest", ``maxshape=(None, ...)`` (an
  extensible array);
- latest-fixed-gzip.h5: libver "latest", gzip, fixed size (a fixed array);
- latest-two-unlimited.h5: libver "latest", two unlimited dimensions
  (a version-2 B-tree);
- latest-dense-links.h5: libver "latest", 12 datasets in one group (links
  in a fractal heap);
- track-order.h5: ``track_order=True`` under the default libver (version-2
  object headers);
- partly-written.h5: resizable datasets grown past what was written, their
  last chunks never written (read as the fill value, 7).

The small files hold the first 16 training and 32 validation images
(latest-dense-links.h5 adds 9 datasets of row indices to the validation
group, for 12 in all), each compressed
(gzip, or LZF for track-order.h5) to keep the directory under 4 MB. ``manifest.json``
holds each dataset's shape, dtype and the SHA-256 of its bytes as h5py
reads them. This script needs h5py and g++ (the collector's rasterizer).
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import h5py
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from ocrl_tpu_torch.config import read_env_config  # noqa: E402
from ocrl_tpu_torch.data.collect import collect_dataset  # noqa: E402

ENV, TRAIN, VAL, SMALL = "random-N5C4S4S2", 240, 256, 32


def rendered() -> dict[str, dict[str, np.ndarray]]:
    with tempfile.TemporaryDirectory() as tmp:
        path = collect_dataset(read_env_config(ENV), TRAIN, VAL, num_proc=4, seed=0,
                               with_masks=True, out_file=Path(tmp) / "ds.hdf5")
        with h5py.File(path, "r") as f:
            return {g: {k: f[g][k][()] for k in f[g]} for g in f}


def write(name: str, groups: dict, file_kw: dict | None = None, **dataset_kw) -> None:
    with h5py.File(HERE / name, "w", **(file_kw or {})) as f:
        for group, datasets in groups.items():
            track = dataset_kw.get("track_order")
            g = f.create_group(group, track_order=track)
            for key, array in datasets.items():
                kw = dict(dataset_kw)
                if kw.pop("unlimited", None) == 2 and array.ndim >= 2:
                    kw["maxshape"] = (None, None) + array.shape[2:]
                elif "maxshape" in kw:
                    kw["maxshape"] = (None,) + array.shape[1:]
                g.create_dataset(key, data=array, **kw)


def main() -> None:
    data = rendered()
    small = {split: {k: v[:SMALL // (2 if split == "TrainingSet" else 1)]
                     for k, v in data[split].items()} for split in data}
    write("eval-gzip.h5", data, compression="gzip", shuffle=True)
    write("lzf-fletcher32.h5", small, compression="lzf", fletcher32=True)
    latest = {"libver": "latest"}
    write("latest-extensible.h5", small, latest, maxshape=True, compression="gzip",
          shuffle=True)
    write("latest-fixed-gzip.h5", small, latest, compression="gzip")
    write("latest-two-unlimited.h5", small, latest, unlimited=2, compression="gzip")
    extra = {f"row_index_{i}": np.arange(SMALL, dtype=np.int64) + i for i in range(9)}
    write("latest-dense-links.h5", {**small, "ValidationSet": {**small["ValidationSet"],
                                                                **extra}},
          latest, compression="gzip")
    write("track-order.h5", small, track_order=True, compression="lzf")
    with h5py.File(HERE / "partly-written.h5", "w") as f:
        for split, datasets in small.items():
            g = f.create_group(split)
            for key, array in datasets.items():
                d = g.create_dataset(key, data=array, chunks=(8,) + array.shape[1:],
                                     maxshape=(None,) + array.shape[1:], fillvalue=7,
                                     compression="gzip")
                d.resize((len(array) + 16,) + array.shape[1:])
    manifest = {"source": f"{ENV}, seed 0, the port's collector; h5py {h5py.__version__}",
                "files": {}}
    for path in sorted(HERE.glob("*.h5")):
        with h5py.File(path, "r") as f:
            manifest["files"][path.name] = {
                g: {k: {"shape": list(f[g][k].shape), "dtype": f[g][k].dtype.str,
                        "sha256": hashlib.sha256(f[g][k][()].tobytes()).hexdigest()}
                    for k in f[g]} for g in f}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    sizes = {p.name: p.stat().st_size for p in HERE.glob("*.h5")}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
