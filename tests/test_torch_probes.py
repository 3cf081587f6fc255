"""The probes of the port against the JAX package's, on the CPU at small
widths (obs 16; SLATE and Slot-Attention with 5 slots of 32, as
test_torch_eval.py's SMALL but for the slot count, which must cover the 4
objects; the VAE at obs 16; IODINE with slots of 8 and 2 iterations):

- ``PropertyPredictor`` for SLATE, Slot-Attention, the VAE and IODINE on the
  same weights (``utils.convert``), the same batch and the same noise (JAX's
  ``jax.random.normal`` replaced by the test's array): the pairwise cost,
  the matched columns, and after two updates every metric, head leaf and
  Adam moment (``get_loss``'s metrics in the entry point's validation
  records); an OCR without slots or pseudo-slots raises as in JAX;
- ``hungarian_matching`` equal to JAX's, ties included;
- the ``Pooling`` wrapper in its three modes (tests/test_poolings.py:60-84's
  VAE-feature setup, and SLATE for the aux loss through the Gumbel fields):
  the pooled output, the aux-loss metrics, the fine-tuned OCR's gradient,
  and ``save`` / ``load`` in JAX's tree;
- both entry points end to end against JAX's ``main`` on one collected file
  with labels and states, from one JAX OCR file: every record of
  metrics.jsonl, the ``model_best.ckpt`` trees both ways (JAX's
  ``load_checkpoint`` reads the port's file with its own template, the port
  loads JAX's), and JAX's quirks: the classifier's file holds the pooling's
  init, the OCR is never trained;
- the port's property step runs the OCR once (one draw, one sweep a slot
  iteration), the classifier's step too;
- the configs against configs/train_{property_predictor,classifier}.yaml.

Tolerances: the cost 1e-6 of its largest entry (one fp32 forward of small
convolutions and Dense layers, summed in another order); metrics, head
leaves and Adam moments 1e-5 of max(|x|, 1), leaf by leaf (Adam's step is
at most lr = 1e-4 an entry, and the moments carry the gradients' fp32
rounding); the pooled outputs and aux-loss metrics 1e-5 of max(|x|, 1); the
fine-tuned OCR's gradient 1e-4 of its leaf's largest entry plus 1e-6 of the
model's (a backward through the convolution stack, as the chip's step
check); the records of the whole loops 1e-5 of max(|x|, 1), over 2 epochs,
but ``R^2_xy`` 3e-5: it divides each sample's squared xy errors by the
spread of its objects' xy, and over the property loop's 6 steps each fp32
side lies up to 1.2e-5 of max(|x|, 1) from a float64 run of the port's
probe on the same batches and weights (JAX 1.15e-5, the port 3.5e-6; the
loss and mse_xy about 1e-6), so the two sides may lie their sum apart. Matched
columns, the OCR's leaves and the pooling's init exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import train_classifier as jtrain_classifier
import train_property_predictor as jtrain_pp
from ocrl_tpu.config import compose
from ocrl_tpu.models import create_ocr as jcreate_ocr
from ocrl_tpu.models.base import normalize_obs as jnormalize
from ocrl_tpu.poolings import Pooling as JPooling
from ocrl_tpu.poolings import get_ocr as jget_ocr
from ocrl_tpu.utils import metrics as jmetrics
from ocrl_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from ocrl_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from ocrl_tpu.utils.property_predictor import PropertyPredictor as JPropertyPredictor

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import train_classifier, train_property_predictor
from ocrl_tpu_torch.config import read_env_config, replace
from ocrl_tpu_torch.data.collect import collect_dataset
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models.base import OCR
from ocrl_tpu_torch.ops import slot_routing
from ocrl_tpu_torch.poolings import Pooling
from ocrl_tpu_torch.poolings import wrapper as twrapper
from ocrl_tpu_torch.utils import checkpoint as tckpt
from ocrl_tpu_torch.utils import metrics as tmetrics
from ocrl_tpu_torch.utils import property_predictor as tpp
from ocrl_tpu_torch.utils.convert import ocr_from_flax, part_from_flax

COST_TOL, TOL, R2_TOL, GRAD_TOL, GRAD_FLOOR = 1e-6, 1e-5, 3e-5, 1e-4, 1e-6
DATASET = ["dataset=target-N4C4S3S1", "dataset.obs_size=16"]
SLATE = ["ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=5", "ocr.slotattr.slot_size=32",
         "ocr.slotattr.mlp_hidden_size=32", "ocr.dvae.vocab_size=32", "ocr.dvae.d_model=32",
         "ocr.tfdec.num_dec_blocks=2", "ocr.tfdec.num_dec_heads=2"]
VARIANTS = {
    "slate": ["ocr=slate"] + SLATE,
    "slotattention": ["ocr=slotattention"] + SLATE,
    "vae": ["ocr=vae"],
    "iodine": ["ocr=iodine_large", "ocr.slot_size=8", "ocr.num_iterations=2"],
}
B = 4


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: tier-1 runs six workers on the host's cores,
    and a pool of torch threads in each spins against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def table(shape, seed=11):
    """The test's standard normals of one shape: the same array for every
    draw of that shape, on both sides."""
    rng = np.random.default_rng([seed, *shape])
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def same_normals(monkeypatch):
    """JAX's normal draws and the port's forward draws (``OCR.rep``) from
    ``table``."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(table(tuple(shape))))
    rep = OCR.rep

    def tabled(self, obs, *, noise=None, grad=False):
        noise = {} if noise is None else noise
        if "rep" not in noise:
            drawn = port_noise(self.module, len(obs))
            noise.update(drawn or {})
        return rep(self, obs, noise=noise, grad=grad)

    monkeypatch.setattr(OCR, "rep", tabled)


def close(got, want, tol=TOL, floor=1.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{err:.3e} > {tol} x {scale:.3e}"


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaves(value, prefix + (str(key),))
    else:
        yield "/".join(prefix), np.asarray(tree)


def close_trees(got, want, tol=TOL):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
    for key, value in want.items():
        close(got[key], value, tol)


def same_trees(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key


def state_dict(tree):
    """A JAX object's tree as flax writes it, numpy leaves."""
    return jax.tree.map(np.asarray, serialization.to_state_dict(tree))


_JAX_OCRS = {}


def jax_ocr(ocr_cfg, env_cfg):
    """JAX's OCR of seed 0 for these configs, built once a module: its init
    is a jit compile of seconds, and no test here changes a JAX OCR's values
    (the classifier's JAX Pooling loads into one the file it was saved to)."""
    key = (repr(ocr_cfg), env_cfg.obs_size, env_cfg.obs_channels,
           env_cfg.get("num_stacked_obss", 1))
    if key not in _JAX_OCRS:
        _JAX_OCRS[key] = jcreate_ocr(ocr_cfg, env_cfg, seed=0)
    return _JAX_OCRS[key]


def cached_get_ocr(ocr_cfg, env_cfg, cpt_cfg, seed=0):
    """JAX's ``get_ocr`` (ocrl_tpu/poolings/wrapper.py:49-63) on ``jax_ocr``'s
    OCR: the same partial load of the configured file, without a second
    init of the same model."""
    assert seed == 0
    ocr = jax_ocr(ocr_cfg, env_cfg)
    tree, _ = jload_checkpoint(cpt_cfg.local_file, ocr.save(), allow_partial=True)
    ocr.load(tree)
    return ocr, True


def ocr_pair(argv, entry="train_property_predictor"):
    """(JAX config, port config, JAX OCR, the port's OCR on the CPU with its
    weights) of ``argv``."""
    jcfg = compose(entry, argv)
    cfg = tcfg.compose(tcfg.TrainPropertyPredictorConfig() if entry == "train_property_predictor"
                       else tcfg.TrainClassifierConfig(), argv)
    jocr = jax_ocr(jcfg.ocr, jcfg.dataset)
    tocr = create_ocr(cfg.ocr, cfg.dataset, seed=0, device="cpu")
    tocr.module.load_state_dict(ocr_from_flax(jax.tree.map(np.asarray, jocr.params)))
    return jcfg, cfg, jocr, tocr


def probe_batch(n=B, seed=3):
    """uint8 images and objects' state rows [n, 4, 5]: colour, shape and
    scale classes and xy in [0, 1]."""
    rng = np.random.default_rng(seed)
    objs = np.concatenate([rng.integers(0, 7, (n, 4, 1)), rng.integers(0, 4, (n, 4, 1)),
                           rng.integers(0, 2, (n, 4, 1)), rng.random((n, 4, 2))], -1)
    return {"obss": rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8),
            "objs": objs.astype(np.float32)}


def port_noise(module, n):
    """The forward's draws of ``module`` for n observations from ``table``,
    as ``OCR.rep`` takes them; None for a module that draws nothing."""
    shape_fn = getattr(module, "noise_shape", None)
    shape = None if shape_fn is None else shape_fn(n)
    return None if shape is None else {"rep": torch.from_numpy(table(tuple(shape)))}


# -- PropertyPredictor -----------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_property_predictor_matches_jax(variant, same_normals):
    jcfg, cfg, jocr, tocr = ocr_pair(VARIANTS[variant] + DATASET)
    jpp = JPropertyPredictor(jocr, jcfg.property_predictor, jcfg.dataset, seed=0)
    probe = tpp.PropertyPredictor(tocr, cfg.property_predictor, cfg.dataset, seed=0)
    probe.head.load_state_dict(part_from_flax("head", state_dict(jpp.params)))
    noise = port_noise(tocr.module, B)
    batches = [probe_batch(seed=3), probe_batch(seed=4)]

    obs = jnormalize(batches[0]["obss"])
    target = jnp.asarray(batches[0]["objs"])
    want_cost = np.asarray(jpp._cost_fn(jpp.params, obs, target, jax.random.PRNGKey(0)))
    got_cost = probe._pairwise_cost(probe._outputs(tpp.normalize_obs(
        torch.from_numpy(batches[0]["obss"])), noise), torch.from_numpy(batches[0]["objs"]))
    slots = 6 if variant in ("vae", "iodine") else 5
    assert want_cost.shape == (B, 4, slots)
    close(got_cost, want_cost, COST_TOL, floor=0.0)

    want_cols, got_cols = [], []
    align = jpp._align
    jpp._align = lambda cost: want_cols.append(align(cost)) or want_cols[-1]
    for step, batch in enumerate(batches):
        want = jpp.update(batch, step)
        got = probe.update(batch, step, noise=noise, matched=got_cols)
        assert set(got) == set(want) == {"loss", "acc_color", "acc_shape", "acc_scale",
                                         "R^2_xy", "mse_xy"}
        for key in want:
            close(got[key], want[key])
    for g, w in zip(got_cols, want_cols, strict=True):
        np.testing.assert_array_equal(g, w)
    tree = probe.save()
    close_trees(tree["property_predictor_module_state_dict"], state_dict(jpp.params))
    close_trees(tree["property_predictor_opt_state_dict"], state_dict(jpp.opt_state))
    assert int(tree["property_predictor_opt_state_dict"]["0"]["count"]) == 2


def test_property_predictor_refuses_ocrs_without_slots():
    argv = ["ocr=naturecnn", "dataset=target-N4C4S3S1"]
    jcfg, cfg = compose("train_property_predictor", argv), \
        tcfg.compose(tcfg.TrainPropertyPredictorConfig(), argv)
    jocr, _ = jget_ocr(jcfg.ocr, jcfg.dataset, jcfg.ocr_checkpoint, seed=0)
    tocr = create_ocr(cfg.ocr, cfg.dataset, seed=0, device="cpu")
    message = "NatureCNN is not supported to predict property."
    with pytest.raises(ValueError, match=message):
        JPropertyPredictor(jocr, jcfg.property_predictor, jcfg.dataset)
    with pytest.raises(ValueError, match=message):
        tpp.PropertyPredictor(tocr, cfg.property_predictor, cfg.dataset)
    bad = replace(cfg.property_predictor, "model_type", "mlp2")
    with pytest.raises(ValueError, match="unknown model_type 'mlp2'"):
        slate = tcfg.compose(tcfg.TrainPropertyPredictorConfig(), VARIANTS["slate"] + DATASET)
        tpp.PropertyPredictor(create_ocr(slate.ocr, slate.dataset, device="cpu"), bad,
                              cfg.dataset)


def test_r2_xy_is_the_explained_to_total_ratio_as_in_jax():
    """JAX's ``R^2_xy`` is mean(sum (pred - mean t)^2 / sum (t - mean t)^2),
    not 1 - SSE / SST (property_predictor.py:135-138): predictions twice as
    far from the objects' mean as the objects score 4 where R^2 is 0. Both
    sides are given the same per-slot outputs."""
    jcfg, cfg, jocr, tocr = ocr_pair(VARIANTS["vae"] + DATASET)
    batch = probe_batch(n=2)
    objs = batch["objs"]
    output = np.zeros((2, 6, 15), np.float32)
    for o in range(4):              # slot o is sure of object o's classes
        output[:, o, 0:7] = -9.0
        output[:, o, 7:11] = -9.0
        output[:, o, 11:13] = -9.0
        for b in range(2):
            output[b, o, int(objs[b, o, 0])] = 9.0
            output[b, o, 7 + int(objs[b, o, 1])] = 9.0
            output[b, o, 11 + int(objs[b, o, 2])] = 9.0
    mean = objs[:, :, 3:5].mean(1, keepdims=True)
    output[:, :4, 13:15] = mean + 2 * (objs[:, :, 3:5] - mean)
    output[:, 4:, 13:15] = 5.0

    jpp = JPropertyPredictor(jocr, jcfg.property_predictor, jcfg.dataset)
    jpp._slot_outputs = lambda params, obs, rng: jnp.asarray(output)
    jpp._build_fns()
    want = jpp.get_loss(batch)
    probe = tpp.PropertyPredictor(tocr, cfg.property_predictor, cfg.dataset)
    probe._outputs = lambda obs, noise: torch.from_numpy(output)
    got = probe.get_loss(batch)
    for key in want:
        close(got[key], float(want[key]))
    assert got["acc_color"] == got["acc_shape"] == got["acc_scale"] == 1.0
    np.testing.assert_allclose(got["R^2_xy"], 4.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["random", "ties", "diff_mat"])
def test_hungarian_matching_matches_jax(case):
    rng = np.random.default_rng(5)
    if case == "ties":          # small integers: many equal costs
        target, inputs = rng.integers(0, 2, (6, 3)), rng.integers(0, 2, (6, 3))
    else:
        target, inputs = rng.random((7, 4)), rng.random((7, 4))
    if case == "diff_mat":
        got, got_diff = tmetrics.hungarian_matching(target, inputs, return_diff_mat=True)
        want, want_diff = jmetrics.hungarian_matching(target, inputs, return_diff_mat=True)
        np.testing.assert_array_equal(got_diff, want_diff)
    else:
        got = tmetrics.hungarian_matching(target, inputs)
        want = jmetrics.hungarian_matching(target, inputs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("probe", ["property", "classifier"])
def test_probe_step_runs_the_ocr_once(probe, monkeypatch):
    """One draw of the forward noise and one sweep a slot iteration a step
    (JAX's property probe runs the OCR twice on one key); the classifier
    never differentiates the OCR, so no backward sweep either."""
    argv = VARIANTS["slate"] + DATASET + (["pooling.d_model=32", "pooling.nhead=4"]
                                          if probe == "classifier" else [])
    cfg = tcfg.compose(tcfg.TrainPropertyPredictorConfig() if probe == "property"
                       else tcfg.TrainClassifierConfig(), argv)
    ocr = create_ocr(cfg.ocr, cfg.dataset, device="cpu")
    batch = probe_batch()
    if probe == "property":
        step = tpp.PropertyPredictor(ocr, cfg.property_predictor, cfg.dataset).update
    else:
        batch["labels"] = np.arange(B, dtype=np.int32)[:, None] % 4
        step = train_classifier.Classifier(Pooling(ocr, cfg.pooling), ocr, 16, 4, 1e-4).step
    calls = {"draws": 0, "sweeps": 0}
    rep, sweep = OCR.rep, slot_routing.route_sweep

    def counted_rep(self, obs, *, noise=None, grad=False):
        noise = {} if noise is None else noise
        out = rep(self, obs, noise=noise, grad=grad)
        calls["draws"] += "rep" in noise
        return out

    def counted_sweep(*args):
        calls["sweeps"] += 1
        return sweep(*args)

    monkeypatch.setattr(OCR, "rep", counted_rep)
    monkeypatch.setattr(slot_routing, "route_sweep", counted_sweep)
    step(batch)
    assert calls == {"draws": 1, "sweeps": cfg.ocr.slotattr.num_iterations}
    assert all(p.grad is None for p in ocr.module.parameters())


# -- the Pooling wrapper -----------------------------------------------------------

POOL_ARGV = ["pooling=transformer", "sb3=ppo", "sb3_acnet=mlp", "env=target-N4C4S3S1",
             "env.obs_size=16"]
POOL_SETUPS = {       # (OCR overrides, the noise a call draws)
    "vae": ["ocr=vae", "ocr.use_cnn_feat=True", "ocr.cnn_feat_size=4"],
    "slate": ["ocr=slate", "ocr.learning.dropout=0", "pooling.d_model=32",
              "pooling.nhead=4"] + SLATE,
}


def pooling_pair(setup, mode, monkeypatch):
    """(JAX Pooling, the port's on the same weights, the port's noise dict)
    in ``mode``, with JAX's draws patched to the port's arrays."""
    flag = {"frozen": [], "aux": ["pooling.learn_aux_loss=True"],
            "downstream": ["pooling.learn_downstream_loss=True"]}[mode]
    argv = POOL_ARGV + POOL_SETUPS[setup] + flag
    jcfg, cfg = compose("train_sb3", argv), tcfg.compose(tcfg.TrainSB3Config(), argv)
    jocr = jax_ocr(jcfg.ocr, jcfg.env)
    tocr = create_ocr(cfg.ocr, cfg.env, seed=0, device="cpu")
    tocr.module.load_state_dict(ocr_from_flax(jax.tree.map(np.asarray, jocr.params)))
    jp = JPooling(jocr, jcfg.pooling, seed=0)
    tp = Pooling(tocr, cfg.pooling, seed=0)
    tp.module.load_state_dict(part_from_flax("pooling_module", state_dict(jp.params)))
    if setup == "vae":
        eps = table((2, cfg.ocr.latent_dim))
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32: jnp.asarray(eps))
        return jp, tp, {"eps": torch.from_numpy(eps)}
    from test_torch_models import TINY

    rng = np.random.default_rng(9)
    e = [rng.exponential(size=(2 * 16, 32)).astype(np.float32) for _ in range(2)]
    slots = table((2, 5, 32))
    calls = []

    def exponential(key, shape, dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(e[(len(calls) - 1) % 2])

    monkeypatch.setattr(jax.random, "exponential", exponential)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(slots))
    return jp, tp, {"soft": torch.from_numpy(-np.log(e[0] + TINY)),
                    "ids": torch.from_numpy(-np.log(e[1] + TINY)),
                    "slots": torch.from_numpy(slots), "rep": torch.from_numpy(slots)}


@pytest.mark.parametrize("setup,mode", [("vae", "frozen"), ("vae", "aux"),
                                        ("vae", "downstream"), ("slate", "aux")])
def test_pooling_matches_jax(setup, mode, monkeypatch):
    jp, tp, noise = pooling_pair(setup, mode, monkeypatch)
    obs = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    rng = jax.random.PRNGKey(5)
    if mode == "aux":
        want, want_metrics = jp._fwd_with_loss(jp._ocr.params, jp.params, jnormalize(obs), rng)
        got, got_metrics = tp(obs, with_loss=True, noise=noise)
        assert "aux_loss" in got_metrics and "loss" not in got_metrics
        assert set(got_metrics) == set(want_metrics)
        for key, value in want_metrics.items():
            close(got_metrics[key], value)
        assert tp(obs, noise=dict(noise)).shape == (2, tp.rep_dim)
    else:
        want = jp._fwd(jp._ocr.params, jp.params, jnormalize(obs), rng)
        got = tp(obs, noise=noise)
        assert tp(obs, with_loss=True, noise=noise)[1] == {}
    close(got, want)
    assert got.requires_grad      # the pooling's own parameters

    # a fixed projection of the output: its plain sum ends in a LayerNorm,
    # whose outputs sum to a constant, so its gradient is rounding alone
    weights = table(tuple(want.shape), seed=12)
    (got * torch.from_numpy(weights)).sum().backward()
    ocr_grads = {n: p.grad for n, p in tp._ocr.module.named_parameters()}
    if mode != "downstream":
        assert all(g is None for g in ocr_grads.values())
        return
    want_grads = ocr_from_flax(jax.tree.map(np.asarray, jax.grad(
        lambda op: (jp._fwd(op, jp.params, jnormalize(obs), rng) * weights).sum())(
            jp._ocr.params)))
    top = max(float(g.abs().max()) for g in want_grads.values())
    for name, want_grad in want_grads.items():
        if name not in ocr_grads or ocr_grads[name] is None:
            assert float(want_grad.abs().max()) == 0.0, name      # the decoder's
            continue
        err = float((ocr_grads[name] - want_grad).abs().max())
        assert err <= GRAD_TOL * float(want_grad.abs().max()) + GRAD_FLOOR * top, name
    assert any(g is not None and float(g.abs().max()) > 0 for g in ocr_grads.values())


def test_pooling_save_and_load_use_jax_trees(monkeypatch):
    jp, tp, _ = pooling_pair("vae", "frozen", monkeypatch)
    want = state_dict(jp.save())
    tree = tp.save()
    assert sorted(tree) == sorted(want) == ["ocr_module_state_dict", "ocr_opt_state_dict",
                                            "pooling_module_state_dict", "pooling_opt_state_dict"]
    same_trees(tree, want)
    fresh = Pooling(tp._ocr, tp._config, seed=3)
    fresh.optimizer.count = 7
    fresh.load(want)
    same_trees(fresh.save(), want)
    identity = Pooling(tp._ocr, tcfg.GROUPS["pooling"]["identity"])
    assert identity.optimizer is None and identity.save()["pooling_module_state_dict"] == {}


# -- the entry points ------------------------------------------------------------------

def probe_file(tmp_path):
    path = tmp_path / "ds.hdf5"
    collect_dataset(replace(read_env_config("target-N4C4S3S1"), "obs_size", 16), 12, 6,
                    with_labels=True, with_states=True, out_file=path)
    return path


def records(path):
    return [json.loads(line) for line in open(path / "metrics.jsonl")]


def check_records(got, want):
    assert [r["_step"] for r in got] == [r["_step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for key in set(w) - {"_step", "_time"}:
            close(g[key], w[key], R2_TOL if key.endswith("R^2_xy") else TOL)


def check_files(tmp_path, jax_template, port_load):
    """The two model_best.ckpt files: JAX reads the port's with its own
    template (no partial load), the port loads JAX's; returns (the port's
    tree, JAX's tree, the port's metadata, JAX's metadata)."""
    got, got_meta = tckpt.load_checkpoint(tmp_path / "port" / "checkpoints" / "model_best.ckpt")
    want, want_meta = tckpt.load_checkpoint(tmp_path / "jax" / "checkpoints" / "model_best.ckpt")
    jload_checkpoint(tmp_path / "port" / "checkpoints" / "model_best.ckpt", jax_template)
    assert sorted(got) == sorted(want)
    port_load(want)
    assert set(got_meta) == set(want_meta)
    for key in got_meta:
        close(got_meta[key], want_meta[key])
    return got, want


def encoder_file(tmp_path, argv):
    """A JAX SLATE of ``argv`` written as an OCR checkpoint; (path, its
    tree, the JAX OCR, which holds what a load of the file gives)."""
    jcfg = compose("train_property_predictor", argv)
    jocr = jax_ocr(jcfg.ocr, jcfg.dataset)
    path = tmp_path / "encoder.ckpt"
    jsave_checkpoint(path, jocr.save(), {"step": 0})
    return path, tckpt.load_checkpoint(path)[0], jocr


def test_train_property_predictor_matches_jax(tmp_path, monkeypatch, same_normals):
    """Both mains, SLATE at the small width, batch 4, 2 epochs of 3 steps
    and 2 validation batches (4 + 2), from one JAX OCR file and JAX's head
    init."""
    data = probe_file(tmp_path)
    argv = VARIANTS["slate"] + DATASET + [f"dataset.datadir={data}", "batch_size=4",
                                          "max_epochs=2"]
    encoder, encoder_tree, jocr = encoder_file(tmp_path, argv)
    argv += [f"ocr_checkpoint.local_file={encoder}"]
    jcfg = compose("train_property_predictor", argv)
    template = JPropertyPredictor(jocr, jcfg.property_predictor, jcfg.dataset, seed=0)
    head_init = state_dict(template.params)

    class JaxInit(tpp.PropertyPredictor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.head.load_state_dict(part_from_flax("head", head_init))

    monkeypatch.setattr(train_property_predictor, "PropertyPredictor", JaxInit)
    monkeypatch.setattr(jtrain_pp, "get_ocr", cached_get_ocr)
    jtrain_pp.main.__wrapped__(compose("train_property_predictor",
                                       argv + [f"run_dir={tmp_path}/jax"]))
    result = train_property_predictor.main(argv + [f"run_dir={tmp_path}/port"], device="cpu")
    assert (result["step"], result["epoch"]) == (6, 1)
    got, want = records(tmp_path / "port"), records(tmp_path / "jax")
    assert [r["_step"] for r in got if "val/loss" in r] == [3, 6]
    check_records(got, want)

    got, want = check_files(tmp_path, template.save(), result["probe"].load)
    close_trees(got, want)
    same_trees(result["probe"].save(), want)
    for key in ("ocr_module_state_dict", "ocr_opt_state_dict"):      # never trained
        same_trees(got[key], encoder_tree[key])
    with pytest.raises(KeyError, match="no 'objs' key"):
        collect_dataset(replace(read_env_config("target-N4C4S3S1"), "obs_size", 16), 4, 2,
                        out_file=tmp_path / "plain.hdf5")
        train_property_predictor.main(argv + [f"dataset.datadir={tmp_path}/plain.hdf5",
                                              f"run_dir={tmp_path}/plain"], device="cpu")


def test_train_classifier_matches_jax(tmp_path, monkeypatch, same_normals):
    """Both mains, SLATE and the Transformer pooling at the small width,
    batch 4, 2 epochs, from one JAX OCR file and JAX's initial pooling and
    head, with ``learn_downstream_loss`` set: JAX's file holds the pooling's
    init beside the trained one, and the OCR as the file gave it, trained by
    neither side whatever the flag says."""
    from flax import linen

    data = probe_file(tmp_path)
    argv = VARIANTS["slate"] + DATASET + [
        "pooling=transformer", "pooling.d_model=32", "pooling.nhead=4",
        "pooling.learn_downstream_loss=True", f"dataset.datadir={data}", "batch_size=4",
        "max_epochs=2"]
    encoder, encoder_tree, jocr = encoder_file(tmp_path, argv)
    argv += [f"pooling.ocr_checkpoint.local_file={encoder}"]
    jcfg = compose("train_classifier", argv)
    jpooling = JPooling(jocr, jcfg.pooling, seed=0)
    pooling_init = state_dict(jpooling.params)
    head = jtrain_classifier.ClassifierHead(jcfg.classifier.d_model, jcfg.dataset.num_labels)
    head_init = state_dict(jax.jit(head.init)(jax.random.PRNGKey(0),
                                              jnp.zeros((1, jpooling.rep_dim)))["params"])
    assert isinstance(head, linen.Module)

    class JaxPooling(Pooling):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.module.load_state_dict(part_from_flax("pooling_module", pooling_init))

    class JaxHead(train_classifier.Classifier):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.head.load_state_dict(part_from_flax("head", head_init))

    monkeypatch.setattr(train_classifier, "Pooling", JaxPooling)
    monkeypatch.setattr(train_classifier, "Classifier", JaxHead)
    monkeypatch.setattr(jtrain_classifier, "get_ocr", cached_get_ocr)
    jtrain_classifier.main.__wrapped__(compose("train_classifier",
                                               argv + [f"run_dir={tmp_path}/jax"]))
    result = train_classifier.main(argv + [f"run_dir={tmp_path}/port"], device="cpu")
    assert (result["step"], result["epoch"]) == (6, 1)
    check_records(records(tmp_path / "port"), records(tmp_path / "jax"))

    template = {"classifier_params": {"pooling": jpooling.params,
                                      "head": jax.tree.map(jnp.asarray, head_init)}}
    template.update(jpooling.save())
    got, want = check_files(tmp_path, template, result["pooling"].load)
    close_trees(got, want)
    for tree in (got, want):                  # the quirk: the pooling's init is saved
        same_trees(tree["pooling_module_state_dict"], pooling_init)
        assert int(tree["pooling_opt_state_dict"]["0"]["count"]) == 0
        for key in ("ocr_module_state_dict", "ocr_opt_state_dict"):
            same_trees(tree[key], encoder_tree[key])
        moved = dict(leaves(tree["classifier_params"]["pooling"]))
        assert any(not np.array_equal(moved[k], v) for k, v in leaves(pooling_init))
    same_trees(result["pooling"].save(), {k: v for k, v in want.items()
                                          if k != "classifier_params"})


# -- the configs ---------------------------------------------------------------------

def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("entry", ["train_property_predictor", "train_classifier"])
def test_probe_configs_match_the_yaml(entry):
    import dataclasses

    argv = ["ocr=slate", "dataset=target-N4C4S3S1"] + (
        ["pooling=transformer"] if entry == "train_classifier" else [])
    want = compose(entry, argv)
    got = tcfg.compose(tcfg.TrainPropertyPredictorConfig() if entry == "train_property_predictor"
                       else tcfg.TrainClassifierConfig(), argv)
    plain = _plain(dataclasses.asdict(got))
    for key, value in plain.items():
        if key == "run_dir":
            assert value == "" and want.run_dir.startswith(
                f"./outputs/{entry}/SLATE-{'Transformer-' if 'classifier' in entry else ''}"
                "TargetN4C4S3S1/")
        elif key in ("ocr", "pooling"):
            continue                           # the groups, as test_torch_package.py holds them
        elif key == "dataset":
            for k, v in value.items():
                if k != "num_stacked_obss":
                    assert v == _plain(want.dataset[k]), k
        elif key == "ocr_checkpoint":
            assert {k: v for k, v in value.items() if k != "finetuning"} == \
                _plain(want[key].to_dict())
        else:
            assert value == _plain(want[key]), key
    assert set(want) - set(plain) == {"device", "num_envs", "wandb"}
