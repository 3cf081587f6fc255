"""The port's train_ocr entry point and its checkpoint files against the JAX
package's, on the CPU at small widths (the SLATE widths of
test_torch_train.py, the VAE, MAE ``tiny`` and IODINE of test_torch_ocrs.py):

- ``packb`` read back by ``flax.serialization.msgpack_restore``;
- ``ocr_to_flax`` the exact inverse of ``ocr_from_flax`` for every OCR;
- checkpoint files both ways, for SLATE, the VAE, MAE and IODINE: a file the
  port writes after two steps is loaded by JAX's ``ocrl_tpu.utils.load``,
  and a file JAX writes is resumed by the port's ``load``, with parameters
  and optimizer state equal to the writer's, bitwise; then one more step on
  each side, on the same draws, agrees;
- NatureCNN's and MultipleCNN's steps advance the optimizer's count as
  JAX's Adam does, leaving the parameters as they are;
- the slice as a whole: JAX's train_ocr.py and the port's
  ``train_ocr.main(..., device="cpu")``, VAE at obs 16, on one collected
  file, across an epoch boundary, then resumed: the same metric records,
  sample images and checkpoint files.

Draws are made equal as in test_torch_pretrain.py: JAX's ``jax.random``
draw is replaced by the test's array while its step traces, and the port is
given the array through ``noise=``; in the whole loop, the port's draw
function is replaced by the same table.

Tolerances (``close``: max |got - want| <= tol x max(max |want|, 1)):
- files and trees: exact (bitwise), dtypes included; sample images within
  one uint8 level;
- the step after a resume: metrics 1e-5; parameters in units of a step as
  test_torch_pretrain.py states (SLATE 1e-2, as test_torch_train.py), the
  entries it holds to Adam's bound held to the bound of a third step
  (``adam_bound``);
- the whole loop: 1e-4 on every logged value over 13 steps and 5
  evaluations; Adam's first steps turn fp32 rounding of the gradients into
  a share of a step that the later losses carry (on these inputs the
  largest deviation is 1.4e-5, at steps 10-13).
"""

import contextlib
import json

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import jax
import jax.numpy as jnp
from flax import serialization

import train_ocr as jtrain_ocr
from ocrl_tpu import utils as jutils
from ocrl_tpu.config import compose
from ocrl_tpu.models import create_ocr as jcreate_ocr

from ocrl_tpu_torch import train_ocr
from ocrl_tpu_torch.config import read_env_config, replace
from ocrl_tpu_torch.data.collect import collect_dataset
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models import vae as tvae
from ocrl_tpu_torch.utils import checkpoint as tck
from ocrl_tpu_torch.utils import png
from ocrl_tpu_torch.utils.convert import attention_heads, ocr_from_flax, ocr_to_flax

from test_torch_ocrs import VARIANTS as OCR_VARIANTS
from test_torch_ocrs import configs
from test_torch_pretrain import DRAWS, MOVE_TOL, _check_params, jax_draws, noise_of, obs_of
from test_torch_train import SMALL, TINY

TOL, LOOP_TOL = 1e-5, 1e-4
B = 2
# lr_warmup_steps 1: in the warm-up's first steps SLATE's lr (1e-8) lies
# below the fp32 spacing of its parameters, and a change in units of a step
# would measure that spacing
SLATE = ["ocr=slate", "ocr.slotattr.fused=auto", "ocr.learning.lr_warmup_steps=1"] + \
    [f"{k}={v}" for k, v in SMALL]
VARIANTS = {"slate": SLATE, "slotattention": SLATE + ["ocr.use_bcdec=True"],
            **{k: OCR_VARIANTS[k] for k in ("vae", "mae", "iodine", "naturecnn",
                                             "multiple_cnn")}}
TRAINED = ["slate", "vae", "mae", "iodine"]


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def close(got, want, tol=TOL):
    err = abs(float(got) - float(want))
    assert err <= tol * max(abs(float(want)), 1.0), (got, want)


def same_tree(got, want, path=""):
    """Equal nested dicts of equal arrays: shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for key in want:
            same_tree(got[key], want[key], f"{path}/{key}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (path, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=path)


def jax_tree(jocr):
    return jax.tree.map(np.asarray, serialization.to_state_dict(jocr.save()))


class Side:
    """One OCR variant on both sides: the JAX OCR (one instance, so that its
    step traces once), the port's configs, a batch and its draws."""

    def __init__(self, name):
        self.name = name
        self.jcfg, self.cfg = configs(VARIANTS[name])
        self.jocr = jcreate_ocr(self.jcfg.ocr, self.jcfg.env, seed=0)
        self.obs = obs_of(self.cfg, B)
        rng = np.random.default_rng(4)
        if name == "slate":
            self.e = [rng.exponential(size=(B * 16, 32)).astype(np.float32) for _ in range(2)]
            self.slots = rng.standard_normal((B, 3, 32)).astype(np.float32)
        elif self.cfg.ocr.name in DRAWS:
            self.noise = noise_of(self.cfg.ocr, self.cfg.env, B)

    def port(self, seed=0):
        return create_ocr(self.cfg.ocr, self.cfg.env, seed=seed, device="cpu")

    @contextlib.contextmanager
    def draws(self):
        """JAX's draws of one step are the test's while open."""
        if self.name == "slate":
            calls = []

            def exponential(key, shape, dtype=jnp.float32):
                calls.append(shape)
                return jnp.asarray(self.e[(len(calls) - 1) % 2])   # soft field, then ids

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.random, "exponential", exponential)
                mp.setattr(jax.random, "normal",
                           lambda key, shape, dtype=jnp.float32: jnp.asarray(self.slots))
                yield
        elif self.cfg.ocr.name in DRAWS:
            with jax_draws(self.cfg.ocr.name, self.noise):
                yield
        else:
            yield

    def port_noise(self):
        if self.name == "slate":
            return {"soft": torch.from_numpy(-np.log(self.e[0] + TINY)),
                    "ids": torch.from_numpy(-np.log(self.e[1] + TINY)),
                    "slots": torch.from_numpy(self.slots)}
        if self.cfg.ocr.name in DRAWS:
            return {DRAWS[self.cfg.ocr.name][0]: torch.from_numpy(self.noise)}
        return None

    def jax_step(self, step):
        with self.draws():
            return {k: float(v) for k, v in self.jocr.update(self.obs, None, step).items()}

    def port_step(self, tocr, step):
        return tocr.update(self.obs, None, step, noise=self.port_noise())

    def next_step_agrees(self, tocr, step):
        """One step on each side from the same state, on the same draws."""
        start = {k: v.clone() for k, v in tocr.module.state_dict().items()}
        want = self.jax_step(step)
        got = self.port_step(tocr, step)
        assert set(got) == set(want)
        for key in want:
            close(got[key], want[key])
        _check_params(tocr, self.jocr, start, adam_bound(tocr), MOVE_TOL.get(self.name, 1e-2))


def adam_bound(tocr):
    """The largest |change| / lr of Adam's next step, t = count + 1:
    |m_t| / sqrt(v_t) <= (1 - b1) / sqrt(1 - b2) * sqrt(sum_j<t (b1^2 / b2)^j)
    by Cauchy-Schwarz, times the bias corrections sqrt(1 - b2^t) / (1 - b1^t);
    1 at the first step, 1.004 at the third."""
    t = tocr.optimizer.count + 1
    b1, b2 = tocr.optimizer.adam.param_groups[0]["betas"]
    s = sum((b1 * b1 / b2) ** j for j in range(t))
    return (1 - b1) / (1 - b2) ** 0.5 * s ** 0.5 * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)


@pytest.fixture(scope="module")
def sides():
    made = {}

    def get(name):
        if name not in made:
            made[name] = Side(name)
        return made[name]
    return get


def test_packb_reads_back_in_flax():
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3), "c": {}},
            "count": np.asarray(7, np.int32), "scalar": np.float64(2.5),
            "ints": [0, 127, 128, 65536, 1 << 40, -1, -33, -40000, -(1 << 40)],
            "floats": 1.25, "text": "x" * 40, "flag": True, "none": None,
            "raw": b"\x00\x01" * 200, "big": {str(i): np.ones(i, np.uint8) for i in range(20)},
            "empty": np.zeros((0, 4), np.int64)}
    back = serialization.msgpack_restore(tck.packb(tree))
    assert set(back) == set(tree)
    for key in ("a", "big"):
        same_tree(back[key], tree[key])
    assert isinstance(back["count"], np.ndarray) and back["count"].shape == ()
    assert back["count"].dtype == np.int32 and back["count"] == 7
    assert back["scalar"] == 2.5 and back["ints"] == tree["ints"]
    assert (back["floats"], back["text"], back["flag"], back["none"], back["raw"]) == \
        (1.25, tree["text"], True, None, tree["raw"])
    same_tree(back["empty"], tree["empty"])
    assert tck.unpackb(tck.packb(tree))["ints"] == tree["ints"]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ocr_to_flax_inverts_ocr_from_flax(sides, name):
    side = sides(name)
    params = jax.tree.map(np.asarray, serialization.to_state_dict(side.jocr.params))
    tocr = side.port()
    tocr.module.load_state_dict(ocr_from_flax(params))
    same_tree(ocr_to_flax(tocr.module.state_dict(), attention_heads(tocr.module)), params)


@pytest.mark.parametrize("name", TRAINED)
def test_port_checkpoint_resumes_in_jax(sides, name, tmp_path):
    """Two port steps, the port's files, JAX's load: the same trees; then
    one more step on each side agrees."""
    side = sides(name)
    tocr = side.port(seed=3)
    for step in range(2):
        tocr.update(side.obs, None, step)
    tck.save(tocr, tmp_path, step=2, epoch=1, best_val_loss=4.5, best=True)
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["model_2.ckpt", "model_best.ckpt", "model_latest.ckpt"]
    assert jutils.load(side.jocr, run_dir=tmp_path) == (2, 1, 4.5)
    same_tree(jax_tree(side.jocr), tck.checkpoint_tree(tocr))
    side.next_step_agrees(tocr, 2)


@pytest.mark.parametrize("name", TRAINED)
def test_jax_checkpoint_resumes_in_the_port(sides, name, tmp_path):
    """Two JAX steps, JAX's files, the port's load: the same trees, torch's
    per-parameter step and the optimizer's count at 2; then one more step on
    each side agrees."""
    side = sides(name)
    side.jocr.params = jax.tree.map(jnp.asarray, side.jocr.params)
    side.jocr.opt_state = side.jocr.tx.init(side.jocr.params)
    for step in range(2):
        side.jax_step(step)
    jutils.save(side.jocr, tmp_path, step=2, epoch=0, best_val_loss=7.0)
    tocr = side.port(seed=9)
    assert tck.load(tocr, run_dir=tmp_path) == (2, 0, 7.0)
    same_tree(tck.checkpoint_tree(tocr), jax_tree(side.jocr))
    assert tocr.optimizer.count == 2
    assert all(float(s["step"]) == 2 for s in tocr.optimizer.adam.state.values())
    assert tck.load(side.port(), run_dir=tmp_path / "none") == (0, 0, 1e10)
    side.next_step_agrees(tocr, 2)


@pytest.mark.parametrize("name", ["naturecnn", "multiple_cnn"])
def test_cnn_steps_advance_the_count_as_jax(sides, name):
    """JAX's Adam takes a step on zero gradients: its count moves and the
    parameters stay. The port's tree after one step is JAX's, bitwise."""
    side = sides(name)
    tocr = side.port()
    tocr.module.load_state_dict(ocr_from_flax(jax.tree.map(np.asarray, side.jocr.params)))
    obs = np.random.default_rng(0).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    side.jocr.update(obs, None, 0)
    assert tocr.update(obs, None, 0) == {}
    assert tocr.optimizer.count == 1
    same_tree(tck.checkpoint_tree(tocr), jax_tree(side.jocr))


def _table(shape):
    """The draw of a given shape, the same on both sides and every call."""
    return np.random.default_rng(list(shape)).standard_normal(shape).astype(np.float32)


def test_train_ocr_matches_jax_end_to_end(tmp_path, monkeypatch):
    """The VAE at obs 16, batch 4, superbatch 2, on a file of 22 training
    and 6 validation images: 8 steps from a JAX initial checkpoint (epoch 0
    of 5 steps, its last through ``update``; then a break mid-epoch 1 at
    step 9), then resumed from the run's own latest file to 12 (step 13).
    Every record of metrics.jsonl (steps, keys, values, the sample files),
    and the checkpoint file names, as JAX's."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(_table(tuple(shape))))
    monkeypatch.setattr(tvae, "given_or_drawn",
                        lambda noise, key, draw: torch.from_numpy(_table(tuple(draw().shape))))
    collect_dataset(replace(read_env_config("random-N5C4S4S2"), "obs_size", 16), 22, 6,
                    out_file=tmp_path / "ds.hdf5")
    common = ["ocr=vae", "dataset=random-N5C4S4S2", f"dataset.datadir={tmp_path}/ds.hdf5",
              "dataset.obs_size=16", "batch_size=4", "superbatch=2", "eval_interval=4",
              "log_interval=2"]
    jcfg = compose("train_ocr", common)
    jutils.save(jcreate_ocr(jcfg.ocr, jcfg.dataset, seed=0), tmp_path / "init", step=0)
    first = [f"load.resume_checkpoint={tmp_path}/init/checkpoints/model_latest.ckpt"]
    for max_steps in (8, 12):
        argv = common + (first if max_steps == 8 else []) + [f"max_steps={max_steps}"]
        jtrain_ocr.main.__wrapped__(compose("train_ocr", argv + [f"run_dir={tmp_path}/jax"]))
        result = train_ocr.main(argv + [f"run_dir={tmp_path}/port"], device="cpu")
    assert (result["step"], result["epoch"]) == (13, 3)

    def records(side):
        return [json.loads(line) for line in open(tmp_path / side / "metrics.jsonl")]

    want, got = records("jax"), records("port")
    assert [r["_step"] for r in got] == [r["_step"] for r in want]
    assert [r["_step"] for r in got if "train/loss" in r] == list(range(13))
    assert [r["_step"] for r in got if "val/loss" in r] == [4, 9, 9, 13, 13]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for key in set(w) - {"_step", "_time"}:
            if isinstance(w[key], float):
                close(g[key], w[key], LOOP_TOL)
            else:
                assert g[key] == w[key], key
    samples = [p for r in got for p in r.get("samples", [])]
    assert samples
    for path in samples:        # uint8 grids of the same arrays: within one level
        image = png.decode((tmp_path / "port" / path).read_bytes())
        want_image = np.asarray(PILImage.open(tmp_path / "jax" / path))
        assert image.shape == want_image.shape and image.shape[-1] == 3
        assert np.abs(image.astype(int) - want_image).max() <= 1, path
    names = {side: sorted(p.name for p in (tmp_path / side / "checkpoints").iterdir())
             for side in ("jax", "port")}
    assert names["port"] == names["jax"] and "model_best.ckpt" in names["port"]
