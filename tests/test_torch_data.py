"""The port's data path against the JAX package's and the libraries it
does without, on the CPU at small sizes (env obs 16, a few dozen images):

- the HDF5 reader (``data.hdf5_format.read_layout``) against h5py's offsets,
  shapes and dtypes on a file JAX's collector wrote; the writer's file read
  by h5py and taken by JAX's ``H5Dataset`` on its memmap path; files outside
  the collectors' subset (chunked, gzip, ``libver="latest"``, big-endian)
  read as h5py reads them, scaleoffset and external storage refused;
- the collector against JAX's, bitwise, with one and two workers;
- the loader's batches against JAX's over two epochs, shuffled and not;
- ``prefetch_to_device`` against JAX's, superbatches, a shape change, and a
  producer's error;
- the PNG writer against PIL, the YAML reader against PyYAML on every file
  under configs/, and the entry points' configs against JAX's compose.

Everything here is exact: integer and uint8 arrays and float32 copies are
compared bitwise, and parsed values by equality.
"""

import dataclasses
import io
import re
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml
from PIL import Image as PILImage

from ocrl_tpu.config import compose
from ocrl_tpu.data import collect as jcollect
from ocrl_tpu.data import hdf5 as jhdf5
from ocrl_tpu.data.prefetch import prefetch_to_device as jprefetch

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.data import collect as tcollect
from ocrl_tpu_torch.data import hdf5 as thdf5
from ocrl_tpu_torch.data import hdf5_format
from ocrl_tpu_torch.data.prefetch import prefetch_to_device
from ocrl_tpu_torch.utils import png

ROOT = Path(__file__).resolve().parents[1]
ENV = "random-N5C4S4S2"
FLAGS = dict(with_masks=True, with_labels=True, with_states=True)


def envs():
    """(JAX's env config, the port's) of ENV at obs 16."""
    jcfg = compose("collect_dataset_from_synthetic_envs", [f"env={ENV}", "env.obs_size=16"])
    return jcfg.env, tcfg.replace(tcfg.read_env_config(ENV), "obs_size", 16)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A file of JAX's collector: 30 training and 10 validation images with
    masks, labels and states, written in chunks of 12."""
    path = tmp_path_factory.mktemp("jax") / "ds.hdf5"
    return jcollect.collect_dataset(envs()[0], 30, 10, seed=3, chunk_size=12,
                                    out_file=path, **FLAGS)


def _h5py_layout(path):
    with h5py.File(path, "r") as f:
        return {g: {k: (f[g][k].id.get_offset(), f[g][k].shape, f[g][k].dtype)
                    for k in f[g]} for g in f}


def test_reader_matches_h5py_on_a_jax_file(jax_file):
    got = hdf5_format.read_layout(jax_file)
    assert got == _h5py_layout(jax_file)
    assert set(got["TrainingSet"]) == {"obss", "num_objs", "masks", "labels", "objs"}


def test_writer_file_reads_back_in_h5py_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"TrainingSet": {"obss": rng.integers(0, 256, (5, 4, 4, 3), dtype=np.uint8),
                              "masks": rng.integers(0, 2, (5, 7, 4, 4, 1), dtype=np.uint8),
                              "num_objs": rng.integers(0, 9, (5,)).astype(np.int64),
                              "labels": rng.integers(0, 4, (5,)).astype(np.int64),
                              "objs": rng.random((5, 5, 5), dtype=np.float32),
                              "extra": rng.random((5, 2)).astype(np.float64),
                              "small": rng.integers(-9, 9, (5, 3)).astype(np.int16)},
              "ValidationSet": {"obss": rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)},
              "Empty": {}}
    path = tmp_path / "port.hdf5"
    offsets = hdf5_format.create(path, {g: {k: (a.shape, a.dtype) for k, a in ds.items()}
                                        for g, ds in arrays.items()})
    with open(path, "r+b") as f:
        for g, ds in arrays.items():
            for k, a in ds.items():
                f.seek(offsets[g][k])
                f.write(a.tobytes())
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(arrays)
        for g, ds in arrays.items():
            assert sorted(f[g]) == sorted(ds)
            for k, a in ds.items():
                assert f[g][k].dtype == a.dtype and f[g][k].shape == a.shape
                assert f[g][k].chunks is None and f[g][k].compression is None
                np.testing.assert_array_equal(f[g][k][()], a)
    assert hdf5_format.read_layout(path) == _h5py_layout(path)
    dataset = jhdf5.H5Dataset(path, "TrainingSet")
    assert dataset._mmap_spec is not None
    np.testing.assert_array_equal(dataset.read_slice(1, 4)["obss"],
                                  arrays["TrainingSet"]["obss"][1:4])


@pytest.mark.parametrize("kind", ["chunked", "gzip", "latest", "big-endian", "scaleoffset",
                                  "external"])
def test_files_outside_the_collectors_subset_read_as_h5py_reads_them(tmp_path, kind):
    """Chunked, gzip-compressed, ``libver="latest"`` and big-endian files
    read as h5py reads them (tests/test_torch_hdf5_layouts.py holds every
    layout); a scaleoffset filter and external storage are refused by name."""
    path = tmp_path / f"{kind}.hdf5"
    options = {"chunked": dict(chunks=(2, 4)), "gzip": dict(compression="gzip"),
               "scaleoffset": dict(scaleoffset=0),
               "external": dict(external=[(str(tmp_path / "raw"), 0, h5py.h5f.UNLIMITED)])
               }.get(kind, {})
    with h5py.File(path, "w", **({"libver": "latest"} if kind == "latest" else {})) as f:
        f.create_group("TrainingSet").create_dataset(
            "obss", data=np.arange(32, dtype=">f4" if kind == "big-endian" else np.uint8)
            .reshape(8, 4), **options)
    refused = {"scaleoffset": "scaleoffset", "external": "external files"}.get(kind)
    if refused:
        with pytest.raises(hdf5_format.UnsupportedHDF5, match=refused):
            hdf5_format.read_layout(path)
        with pytest.raises(hdf5_format.UnsupportedHDF5, match=refused):
            thdf5.H5Dataset(path, "TrainingSet")
        return
    got = thdf5.H5Dataset(path, "TrainingSet").read_slice(1, 7)["obss"]
    want = jhdf5.H5Dataset(path, "TrainingSet").read_slice(1, 7)["obss"]
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with h5py.File(path, "r") as f:
        assert thdf5.read_array(path, hdf5_format.read_layout(path)["TrainingSet"]["obss"]
                                ).tobytes() == f["TrainingSet"]["obss"][()].tobytes()


@pytest.mark.parametrize("num_proc", [1, 2])
def test_collector_matches_jax_bitwise(tmp_path, num_proc):
    jenv, tenv = envs()
    jpath = jcollect.collect_dataset(jenv, 14, 5, num_proc=num_proc, seed=7, chunk_size=6,
                                     out_file=tmp_path / "jax.hdf5", **FLAGS)
    tpath = tcollect.collect_dataset(tenv, 14, 5, num_proc=num_proc, seed=7, chunk_size=6,
                                     out_file=tmp_path / "port.hdf5", **FLAGS)
    with h5py.File(jpath, "r") as a, h5py.File(tpath, "r") as b:
        assert list(a) == list(b)
        for g in a:
            assert list(a[g]) == list(b[g])
            for k in a[g]:
                assert a[g][k].dtype == b[g][k].dtype
                np.testing.assert_array_equal(a[g][k][()], b[g][k][()], err_msg=f"{g}/{k}")
    assert tcollect.canonical_filename(tenv, 14, 5, 7) == \
        jcollect.canonical_filename(jenv, 14, 5, 7)
    name = tcollect.collect_dataset(tenv, 2, 1, out_dir=tmp_path)
    assert name.name == jcollect.canonical_filename(jenv, 2, 1, 0)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_gives_jax_batches(jax_file, shuffle):
    """Two passes over each split, chunks of 8 rows under the split's 30."""
    for split in ("TrainingSet", "ValidationSet"):
        jl = jhdf5.DataLoader(jhdf5.H5Dataset(jax_file, split), 4, shuffle=shuffle, seed=5,
                              chunk_size=8)
        tl = thdf5.DataLoader(thdf5.H5Dataset(jax_file, split), 4, shuffle=shuffle, seed=5,
                              chunk_size=8)
        assert len(jl) == len(tl)
        for _ in range(2):
            want, got = list(jl), list(tl)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert set(g) == set(w) == {"obss", "masks", "labels", "objs"}
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_get_dataloaders_resolves_the_file(jax_file, tmp_path):
    cfg = dataclasses.replace(tcfg.read_dataset_config(ENV), datadir=str(jax_file))
    train, val = thdf5.get_dataloaders(cfg, 4, seed=2)
    assert train.shuffle and not val.shuffle
    assert (len(train), len(val)) == (7, 3)          # 30 rows: the last 2 dropped; 10 kept
    assert [len(b["obss"]) for b in val] == [4, 4, 2]
    assert sum(len(b["obss"]) for b in train) == 28
    missing = dataclasses.replace(cfg, datadir=str(tmp_path / "none.hdf5"))
    with pytest.raises(FileNotFoundError, match="collect_dataset_from_synthetic_envs"):
        thdf5.resolve_datafile(missing, repo_root=tmp_path)
    cfg = dataclasses.replace(cfg, datadir=None, dataset_dir="data",
                              dataset_checkpoint=tcfg.DatasetCheckpointConfig(file="ds.hdf5"))
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "ds.hdf5").write_bytes(Path(jax_file).read_bytes())
    assert thdf5.resolve_datafile(cfg, repo_root=tmp_path) == tmp_path / "data" / "ds.hdf5"


def _stream():
    """Batches of 2 rows, a change of shape after the fourth, then a
    partial batch: what a loader's trailing batch looks like."""
    rng = np.random.default_rng(1)
    sizes = [2, 2, 2, 2, 3, 3, 3, 1]
    return [{"obss": rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
             "masks": rng.random((n, 2, 4, 4, 1), dtype=np.float32)} for n in sizes]


@pytest.mark.parametrize("superbatch,whole", [(1, False), (1, True), (3, False), (3, True)])
def test_prefetch_gives_jax_items(superbatch, whole):
    items = _stream()
    want = list(jprefetch(items, size=2, superbatch=superbatch, yield_whole=whole))
    got = list(prefetch_to_device(items, "cpu", size=2, superbatch=superbatch,
                                  yield_whole=whole))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_prefetch_raises_the_producers_error_and_stops_early():
    def failing():
        yield _stream()[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(failing(), "cpu"))
    pulled = []

    def endless():
        while True:
            pulled.append(1)
            yield _stream()[0]

    stream = prefetch_to_device(endless(), "cpu", size=2)
    next(stream)
    stream.close()              # the producer thread is joined
    n = len(pulled)
    assert n <= 5 and len(pulled) == n


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9), (6, 3, 1)])
def test_png_decodes_in_pil(shape):
    image = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    data = png.encode(image)
    got = np.asarray(PILImage.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got, image.reshape(got.shape))
    np.testing.assert_array_equal(png.decode(data), image.reshape(got.shape))
    bad = bytearray(data)
    bad[-20] ^= 1
    with pytest.raises(ValueError):
        png.decode(bytes(bad))


class _OmegaLoader(yaml.SafeLoader):
    """PyYAML's SafeLoader with OmegaConf's float rule (ocrl_tpu/config/compose.py)."""


_OmegaLoader.add_implicit_resolver("tag:yaml.org,2002:float", re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X), list("-+0123456789."))


@pytest.mark.parametrize("group", sorted(
    {p.parent.name for p in (ROOT / "configs").rglob("*.yaml")}))
def test_yaml_reader_matches_pyyaml(group):
    """Every file of configs/<group>: the reader's mapping equals PyYAML's,
    and where PyYAML refuses a file (two CausalWorld dataset files are not
    YAML) the reader raises too."""
    paths = sorted((ROOT / "configs" / group).glob("*.yaml")) if group != "configs" \
        else sorted((ROOT / "configs").glob("*.yaml"))
    assert paths
    for path in paths:
        text = path.read_text()
        try:
            want = yaml.load(text, Loader=_OmegaLoader) or {}
        except yaml.YAMLError:
            with pytest.raises(ValueError):
                tcfg.parse_yaml(text)
            continue
        assert tcfg.parse_yaml(text) == want, path.name


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("dataset", ["random-N5C4S4S2", "target-N4C4S3S1",
                                     "odd-one-out-N4C2S2S1-oc", "push-N3C4S1S1"])
def test_train_ocr_config_matches_jax(dataset):
    argv = ["ocr=vae", f"dataset={dataset}", "batch_size=8", "dataset.datadir=x.hdf5",
            "load.resume_checkpoint=a/b.ckpt", "+max_steps=64"]
    want = compose("train_ocr", argv)
    got = tcfg.compose(tcfg.TrainOCRConfig(), argv)
    assert _plain(dataclasses.asdict(got.ocr)) == _plain(want.ocr.to_dict())
    for key, value in dataclasses.asdict(got.dataset).items():
        if key == "num_stacked_obss":       # EnvConfig's field; the dataset files lack it
            assert value == 1 and key not in want.dataset
            continue
        assert _plain(value) == _plain(want.dataset[key]), key
    for key in ("eval_interval", "batch_size", "num_visualization", "tags", "seed",
                "num_workers", "max_epochs", "max_steps"):
        assert getattr(got, key) == want[key], key
    assert dataclasses.asdict(got.load) == want.load.to_dict()
    defaults = tcfg.TrainOCRConfig()
    assert (defaults.log_interval, defaults.superbatch, defaults.max_steps,
            defaults.profile_dir) == (50, 16, None, None)


def test_collect_config_matches_jax():
    argv = [f"env={ENV}", "collection.num_tr=10", "collection.with_masks=True",
            "+collection.out_file=d.hdf5"]
    want = compose("collect_dataset_from_synthetic_envs", argv)
    got = tcfg.compose(tcfg.CollectConfig(), argv)
    assert _plain(dataclasses.asdict(got.collection)) == _plain(want.collection.to_dict())
    for key, value in want.env.to_dict().items():
        assert _plain(dataclasses.asdict(got.env)[key]) == _plain(value), key
    with pytest.raises(KeyError):
        tcfg.compose(tcfg.CollectConfig(), ["dataset=random-N5C4S4S2"])
    # resume= is train_sb3's agent file, and is not read for train_ocr
    assert tcfg.compose(tcfg.TrainSB3Config(), ["resume=r.ckpt"]).resume == "r.ckpt"
    with pytest.raises(KeyError):
        tcfg.compose(tcfg.TrainOCRConfig(), ["resume=True"])
