"""The OCR pretraining of VAE, MAE and IODINE in the port against the JAX
package's, at small widths: the same weights (utils.convert.ocr_from_flax),
the same inputs and the same numpy noise (JAX's ``jax.random.normal`` /
``jax.random.uniform`` replaced by the test's array while its step traces;
the port given the array through ``noise=``):

- each loss and its metrics through ``OCR.get_loss``: the VAE at obs 16
  (its reported ``kld`` is minus the KL term), MAE ``tiny`` with patch 4 at
  obs 16, IODINE narrow (slots of 8, 2 iterations, obs 16), and IODINE with
  masks (its foreground ``ari``);
- two ``update_many`` steps with k = 2: metrics, IODINE's 2-norm ``norm``,
  every parameter after them;
- MAE's AdamW decay mask leaf by leaf against JAX's, IODINE's ``kld`` on the
  posterior after the last refinement, the clip by either order;
- the committed artifacts/encoders/{vae,iodine}.ckpt at full width, batch 2;
- ``get_ari_mse`` of IODINE against the JAX loop, and its refusal of the
  OCRs without masks; NatureCNN's and MultipleCNN's steps; ``sample_arrays``
  and ``samples_grid``; ``train_ocr.main`` with masks and MAE's lr rule.

Tolerances (``close``: max |got - want| <= tol x max(max |want|, floor)):
- losses and metrics 1e-5 of max(|value|, 1): fp32 sums in another order
  (on these inputs at most 3.6e-6, IODINE's ``kld``);
- parameters after two steps, in units of a step: each entry's change over
  its lr, port against JAX, within VAE 1e-2, MAE 1e-3, IODINE 1e-1 where
  the entry's sqrt(nu) in Adam exceeds 1e-1 of its leaf's largest and 1e-6
  of the model's (18 % of the VAE's entries, 35 % of MAE's, 14 % of
  IODINE's). Adam divides by sqrt(nu), so an entry with a small gradient,
  the sum of terms that nearly cancel, turns their rounding into a share of
  a step (one entry of the VAE's ``in_dec.bias``, gradients 0.154 then
  -0.112 against its leaf's 60, moves 0.1 step apart between JAX and
  float64); there each side's change is held to Adam's bound, steps x
  (1 + weight_decay x |p|) x (1 + 1e-3), as are MAE's attention key biases,
  whose gradient is zero in exact arithmetic (a key bias adds the same
  q . b to every logit of a query's softmax). From a float64 run of the
  port on the same weights, inputs and noise, on the compared entries: the
  port 4.6e-4, 1.1e-4 and 1.5e-2 of a step, JAX 4.7e-3, 1.1e-4 and 4.8e-2
  (IODINE's refinement network takes the inner ELBO gradients as inputs),
  port against JAX 4.7e-3, 1.2e-4 and 6.3e-2;
- the committed encoders' losses at full width: VAE 1e-5; IODINE 1e-4 of
  max(|value|, 1), from a float64 run of the port on the same weights and
  noise, from which each fp32 side lies about as far as from the other
  (``test_committed_encoder_loss_matches_jax`` holds all three pairs);
- sample arrays as the loss; ARI within 1e-6 (exact integer counts).
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.models import build_spec
from ocrl_tpu.models import create_ocr as jcreate_ocr
from ocrl_tpu.models.base import clip_by_total_norm as jclip
from ocrl_tpu.poolings import get_ocr as jget_ocr
from ocrl_tpu.utils.checkpoint import save_checkpoint

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import train_ocr
from ocrl_tpu_torch.data.collect import collect_dataset
from ocrl_tpu_torch.get_ari_mse import batches_of, evaluate, evaluate_arrays
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models.base import clip_by_total_norm
from ocrl_tpu_torch.models.iodine import _kl_std_normal
from ocrl_tpu_torch.train_ocr import pretraining_config
from ocrl_tpu_torch.utils.checkpoint import get_ocr
from ocrl_tpu_torch.utils.convert import _leaf, _module, ocr_from_flax

from test_torch_eval import painted
from test_torch_ocrs import ROOT, VARIANTS, configs, frames

TOL, FLOOR = 1e-5, 1e-2
MOVE_TOL = {"vae": 1e-2, "mae": 1e-3, "iodine": 1e-1}
SURE, SURE_FLOOR = 1e-1, 1e-6
FULL_TOL = {"vae": 1e-5, "iodine": 1e-4}
ARI_TOL = 1e-6
B = 2
# the draw each loss makes: (its noise key, the JAX function it replaces)
DRAWS = {"VAE": ("eps", "normal"), "MAE": ("masking", "uniform"), "Iodine": ("eps", "normal")}


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def close(got, want, tol=TOL, floor=1.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err:.3e} > {tol} x {scale:.3e}"


def noise_of(ocr_cfg, env_cfg, batch, seed=5):
    """The numpy draw of one loss at ``batch``: the VAE's eps [B, latent],
    MAE's masking order [B, N], IODINE's eps [N, B, K, L]."""
    rng = np.random.default_rng(seed)
    if ocr_cfg.name == "VAE":
        return rng.standard_normal((batch, ocr_cfg.latent_dim)).astype(np.float32)
    if ocr_cfg.name == "MAE":
        return rng.random((batch, (env_cfg.obs_size // ocr_cfg.patch_size) ** 2),
                          dtype=np.float32)
    return rng.standard_normal((ocr_cfg.num_iterations, batch, ocr_cfg.num_slots,
                                ocr_cfg.slot_size)).astype(np.float32)


@contextlib.contextmanager
def jax_draws(name, noise):
    """JAX's draw of OCR ``name`` returns ``noise`` while the context is
    open (a JAX step traced inside keeps it)."""
    fn = DRAWS[name][1]
    saved = getattr(jax.random, fn)
    setattr(jax.random, fn, lambda *args, **kwargs: jnp.asarray(noise))
    try:
        yield
    finally:
        setattr(jax.random, fn, saved)


def pair(variant, seed=0):
    """(JAX OCR, the port's OCR on the CPU with its weights, port config)."""
    jcfg, cfg = configs(VARIANTS[variant])
    jocr = jcreate_ocr(jcfg.ocr, jcfg.env, seed=seed)
    tocr = create_ocr(cfg.ocr, cfg.env, seed=seed, device="cpu")
    tocr.module.load_state_dict(ocr_from_flax(jax.tree.map(np.asarray, jocr.params)))
    return jocr, tocr, cfg


def obs_of(cfg, n, seed=7):
    S = cfg.env.obs_size
    return np.random.default_rng(seed).integers(0, 256, (n, S, S, 3), dtype=np.uint8)


def masks_of(cfg, n, seed=8):
    return painted(n, cfg.env.obs_size, K=4, seed=seed)[1]


def check_metrics(got, want):
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key])


@pytest.mark.parametrize("variant", ["vae", "mae", "iodine", "iodine-masks"])
def test_loss_matches_jax(variant):
    """OCR.get_loss of each OCR: loss and every metric, on the same noise."""
    jocr, tocr, cfg = pair(variant.split("-")[0])
    obs = obs_of(cfg, B)
    masks = masks_of(cfg, B) if variant.endswith("masks") else None
    noise = noise_of(cfg.ocr, cfg.env, B)
    with jax_draws(cfg.ocr.name, noise):
        want = jocr.get_loss(obs, masks)
    key = DRAWS[cfg.ocr.name][0]
    got = tocr.get_loss(obs, masks, noise={key: torch.from_numpy(noise)})
    check_metrics(got, want)
    if cfg.ocr.name == "VAE":
        assert float(got["kld"]) < 0      # minus the KL term, as JAX reports it
    if masks is not None:
        np.testing.assert_allclose(float(got["ari"]), float(want["ari"]), atol=ARI_TOL)


def _check_params(tocr, jocr, start, steps, move_tol):
    """Every parameter of the port against JAX's after ``steps`` steps from
    ``start``, in units of a step: on the entries whose sqrt(nu) in the
    port's Adam lies above SURE of its leaf's largest and SURE_FLOOR of the
    model's, the two sides' change over lr within ``move_tol``; on the
    others each side's change within Adam's bound."""
    want = ocr_from_flax(jax.tree.map(np.asarray, jocr.params))
    got = tocr.module.state_dict()
    assert set(got) == set(want)
    params = dict(tocr.module.named_parameters())
    for key in set(got) - set(params):
        close(got[key], want[key])
    groups = {id(p): g for g in tocr.optimizer.adam.param_groups for p in g["params"]}
    rms = {key: tocr.optimizer.adam.state[p]["exp_avg_sq"].sqrt() for key, p in params.items()}
    top = max(r.max() for r in rms.values())
    for key, p in params.items():
        lr, decay = groups[id(p)]["lr"], groups[id(p)]["weight_decay"]
        moved = [(side - start[key]) / lr for side in (got[key], want[key])]
        sure = (rms[key] > SURE * rms[key].max()) & (rms[key] > SURE_FLOOR * top)
        err = (moved[0] - moved[1]).abs()[sure]
        assert not sure.any() or err.max() <= move_tol, (key, float(err.max()))
        bound = steps * (1 + decay * start[key].abs()) * (1 + 1e-3)
        for side in moved:
            assert bool((side.abs() <= bound)[~sure].all()), key


@pytest.mark.parametrize("variant", ["vae", "mae", "iodine", "iodine-masks"])
def test_update_many_matches_jax(variant):
    """Two steps through update_many (k = 2) from the same weights, on the
    same noise in both steps (JAX traces its scan once with it): stacked
    metrics, IODINE's 2-norm ``norm`` before its clip, every parameter."""
    name = variant.split("-")[0]
    jocr, tocr, cfg = pair(name)
    obs = obs_of(cfg, 2 * B)
    masks = masks_of(cfg, 2 * B) if variant.endswith("masks") else None
    noise = noise_of(cfg.ocr, cfg.env, B)
    start = {k: v.clone() for k, v in tocr.module.state_dict().items()}
    with jax_draws(cfg.ocr.name, noise):
        want = jocr.update_many(obs, masks, 0, 2)
    got = tocr.update_many(obs, masks, 0, 2,
                           noise={DRAWS[cfg.ocr.name][0]: torch.from_numpy(noise)})
    check_metrics(got, want)
    assert ("norm" in got) == (name == "iodine")
    assert tocr.optimizer.count == 2 and tocr._last_step == 1
    _check_params(tocr, jocr, start, 2, MOVE_TOL[name])


def test_mae_decay_mask_matches_jax():
    """The port's AdamW decays exactly the leaves JAX's no-decay mask
    decays: JAX's optimizer, fed zero gradients on parameters of ones,
    moves only its decayed leaves. Each leaf goes to its port parameter
    by utils.convert's name map; LayerNorm weights (JAX's ``scale``) and
    attention biases are not decayed, ``cls_token`` and ``mask_token`` are."""
    jcfg, cfg = configs(VARIANTS["mae"])
    spec = build_spec(jcfg.ocr, jcfg.env)
    jocr = jcreate_ocr(jcfg.ocr, jcfg.env, seed=0)
    ones = jax.tree.map(jnp.ones_like, jocr.params)
    updates, _ = spec.optimizer.update(jax.tree.map(jnp.zeros_like, ones),
                                       spec.optimizer.init(ones), ones)
    want = {}
    for path, u in jax.tree_util.tree_leaves_with_path(updates):
        keys = ["ocr_module"] + [p.key for p in path]
        module = _module("/".join(keys[:-1]))
        name, _ = _leaf(module, keys[-1], np.asarray(u))
        want[f"{module}.{name}"[len("ocr_module."):]] = bool(np.any(np.asarray(u) != 0))
    tocr = create_ocr(cfg.ocr, cfg.env, seed=0, device="cpu")
    names = {id(p): n for n, p in tocr.module.named_parameters()}
    got = {names[id(p)]: g["group"] == "decay"
           for g in tocr.optimizer.adam.param_groups for p in g["params"]}
    assert got == want
    assert got["cls_token"] and got["mask_token"] and not got["encoder_norm.weight"]
    assert not got["blocks.0.attn.query.bias"] and got["blocks.0.attn.query.weight"]
    decays = {g["group"]: (g["weight_decay"], g["betas"]) for g in tocr.optimizer.adam.param_groups}
    assert decays == {"decay": (0.05, (0.9, 0.95)), "no_decay": (0.0, (0.9, 0.95))}


def test_iodine_kld_is_taken_after_the_last_refinement():
    """IODINE's ``kld`` is the KL of the posterior the N-th refinement
    leaves, not of the one its last draw used: the port's metric equals the
    former and differs from the latter (and JAX's, in
    test_loss_matches_jax)."""
    _, cfg = configs(VARIANTS["iodine"])
    tocr = create_ocr(cfg.ocr, cfg.env, seed=0, device="cpu")
    module = tocr.module
    obs = torch.from_numpy(obs_of(cfg, B)).float() / 255
    eps = torch.from_numpy(noise_of(cfg.ocr, cfg.env, B))

    def posterior_of_last_draw(image, eps, outer):
        means, logsigs, state = module._initial(image)
        for it in range(cfg.ocr.num_iterations - 1):
            *_, means, logsigs, state = module._refine(image[:, None], means, logsigs, state,
                                                      eps[it], outer)
        return means, logsigs

    with torch.no_grad():
        _, metrics = module.loss(obs, noise={"eps": eps})
        *_, means, logsigs = module._full(obs, None, {"eps": eps})
        before = module._with_autograd(obs, eps, None, posterior_of_last_draw)
    torch.testing.assert_close(metrics["kld"], _kl_std_normal(means, logsigs).sum() / B)
    last_draw = _kl_std_normal(before[0], before[1]).sum() / B
    assert abs(float(metrics["kld"]) - float(last_draw)) > 1e-3


@pytest.mark.parametrize("ord_", [2.0, float("inf")])
def test_clip_matches_jax(ord_):
    """The clip by the 2-norm (IODINE) and by the inf-norm (SLATE) over all
    leaves together, with its 1e-6, and its ``norm``."""
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": (rng.standard_normal(5) * 3).astype(np.float32)}
    want, _ = jclip(0.5, ord_).update(grads, None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads.values()]
    for p, g in zip(params, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_total_norm(params, 0.5, ord_)
    flat = np.concatenate([g.ravel() for g in grads.values()])
    np.testing.assert_allclose(norm.item(), np.linalg.norm(flat, ord_), rtol=1e-6)
    for p, w in zip(params, want.values()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("name", ["vae", "iodine"])
def test_committed_encoder_loss_matches_jax(name):
    """The loss and metrics of artifacts/encoders/{name}.ckpt at full width
    on 2 env frames, each package reading the file itself, against JAX and,
    for IODINE-large, both against the port in float64."""
    ocr = "iodine_large" if name == "iodine" else "vae"
    jcfg, cfg = configs([f"ocr={ocr}", "pooling.ocr_checkpoint.local_file="
                         f"{ROOT}/artifacts/encoders/{name}.ckpt"])
    jocr, jpre = jget_ocr(jcfg.ocr, jcfg.env, jcfg.pooling.ocr_checkpoint, seed=0)
    tocr, pre = get_ocr(cfg.ocr, cfg.env, cfg.pooling.ocr_checkpoint, 0, "cpu")
    assert jpre and pre
    obs = (frames(cfg.env, B) * 255).round().astype(np.uint8)
    noise = noise_of(cfg.ocr, cfg.env, B, seed=9)
    with jax_draws(cfg.ocr.name, noise):
        want = jocr.get_loss(obs)
    key = DRAWS[cfg.ocr.name][0]
    got = tocr.get_loss(obs, noise={key: torch.from_numpy(noise)})
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], FULL_TOL[name])
    if name == "iodine":
        module = tocr.module.double()
        with torch.no_grad():
            _, ref = module.loss(torch.from_numpy(obs).double() / 255,
                                 noise={key: torch.from_numpy(noise).double()})
        for k in want:
            close(got[k], ref[k].numpy(), FULL_TOL[name])
            close(want[k], ref[k].numpy(), FULL_TOL[name])


def _jax_eval_loop(jocr, batches):
    """The loop of the repo-root get_ari_mse.py:55-73 for IODINE."""
    aris, mses = [], []
    for batch in batches:
        m = jocr.get_loss(batch["obss"], batch["masks"])
        aris.append(float(np.asarray(m["ari"])))
        mses.append(float(np.asarray(m["mse"])))
    return {"ari": float(np.mean(aris)), "mse": float(np.mean(mses))}


def test_evaluate_scores_iodine_as_jax_does(tmp_path):
    """get_ari_mse.evaluate of IODINE on 2 batches of 4 painted scenes:
    ARI and MSE of each batch's loss against the JAX loop, on a checkpoint
    the JAX package wrote and the same noise; ``main`` loads it and gives
    what ``evaluate`` gives."""
    jocr, _, cfg = pair("iodine", seed=2)
    obs, masks = painted(8, cfg.env.obs_size, K=4, seed=3)
    data = {"obss": obs, "masks": masks}
    noise = noise_of(cfg.ocr, cfg.env, 4)
    with jax_draws("Iodine", noise):
        want = _jax_eval_loop(jocr, batches_of(data, 4))
    path = tmp_path / "model_best.ckpt"
    save_checkpoint(path, jocr.save(), {"step": 0})
    port = tcfg.GetAriMseConfig(ocr=cfg.ocr, dataset=tcfg.DatasetConfig(obs_size=cfg.env.obs_size),
                                batch_size=4,
                                ocr_checkpoint=tcfg.OCRCheckpointConfig(local_file=str(path)))
    tocr, pretrained = get_ocr(port.ocr, port.dataset, port.ocr_checkpoint, 0, "cpu")
    assert pretrained
    got = evaluate(tocr, batches_of(data, 4), noise=[{"eps": torch.from_numpy(noise)}
                                                     for _ in range(2)])
    np.testing.assert_allclose(got["ari"], want["ari"], atol=ARI_TOL)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=TOL)
    assert all(b["gen_s"] == 0.0 for b in got["batches"])
    ran = evaluate_arrays(port, data, device="cpu")
    again = evaluate(get_ocr(port.ocr, port.dataset, port.ocr_checkpoint, 0, "cpu")[0],
                     batches_of(data, 4), port.seed)
    assert (ran["ari"], ran["mse"]) == (again["ari"], again["mse"])
    assert np.isfinite([ran["ari"], ran["mse"]]).all()


@pytest.mark.parametrize("ocr", ["vae", "mae"])
def test_get_ari_mse_refuses_ocrs_without_masks(ocr):
    """VAE and MAE produce no masks: evaluate_arrays and evaluate raise
    ValueError, as the JAX entry does."""
    _, cfg = configs(VARIANTS[ocr])
    obs, masks = painted(2, cfg.env.obs_size, seed=1)
    port = tcfg.GetAriMseConfig(ocr=cfg.ocr, dataset=tcfg.DatasetConfig(obs_size=cfg.env.obs_size))
    with pytest.raises(ValueError, match="mask-producing"):
        evaluate_arrays(port, {"obss": obs, "masks": masks}, device="cpu")
    with pytest.raises(ValueError, match="mask-producing"):
        evaluate(create_ocr(cfg.ocr, cfg.env, 0, "cpu"), [{"obss": obs, "masks": masks}])


@pytest.mark.parametrize("variant", ["naturecnn", "multiple_cnn"])
def test_cnn_steps_change_nothing_as_jax(variant):
    """NatureCNN's and MultipleCNN's loss is 0 * sum(rep) with no metrics:
    a step (and update_many) returns {} and leaves every parameter as it
    was, on both sides."""
    jocr, tocr, cfg = pair(variant)
    obs = obs_of(cfg, 4)
    start = {k: v.clone() for k, v in tocr.module.state_dict().items()}
    jstart = jax.tree.map(np.asarray, jocr.params)
    assert jocr.update(obs[:2], None, 0) == {} and tocr.update(obs[:2], None, 0) == {}
    assert tocr.update_many(obs, None, 1, 2) == {} and tocr.get_loss(obs) == {}
    assert all(torch.equal(v, start[k]) for k, v in tocr.module.state_dict().items())
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(jocr.params), jax.tree.leaves(jstart)))
    assert tocr.optimizer.count == 3


@pytest.mark.parametrize("variant", ["vae", "mae", "iodine"])
def test_samples_match_jax(variant):
    """OCR.get_samples: the module's sample arrays on the same noise,
    assembled by samples_grid into the same uint8 grid as JAX's (an entry
    may round to the next level where the two fp32 values straddle one)."""
    jocr, tocr, cfg = pair(variant)
    obs = obs_of(cfg, B)
    noise = noise_of(cfg.ocr, cfg.env, B)
    with jax_draws(cfg.ocr.name, noise):
        want = jocr.get_samples(obs)["samples"]
        arrays = jax.device_get(jocr._sample_arrays(jocr.params, jnp.asarray(obs / 255.0,
                                                                              jnp.float32),
                                                    jax.random.PRNGKey(0)))
    key = DRAWS[cfg.ocr.name][0]
    got = tocr.get_samples(obs, noise={key: torch.from_numpy(noise)})["samples"]
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with torch.no_grad():
        tarrays = tocr.module.sample_arrays(torch.from_numpy(obs).float() / 255,
                                            noise={key: torch.from_numpy(noise)})
    for g, w in zip(tarrays, arrays):
        close(g, w)


def test_train_passes_masks_and_scales_mae_lr(tmp_path):
    """train_ocr.main: a file with masks gives an ``ari`` every step; MAE
    trains at lr x batch_size / 256 (train_ocr.py:34-36), the other OCRs at
    their own lr."""
    _, cfg = configs(VARIANTS["iodine"])
    collect_dataset(tcfg.replace(tcfg.read_env_config("random-N5C4S4S2"), "obs_size", 16),
                    4, 2, with_masks=True, out_file=tmp_path / "ds.hdf5")

    def run(variant, name):
        argv = [a.replace("env.", "dataset.") for a in VARIANTS[variant]]
        return train_ocr.main(argv + ["dataset=random-N5C4S4S2",
                                      f"dataset.datadir={tmp_path}/ds.hdf5",
                                      "batch_size=2", "superbatch=2", "max_steps=2",
                                      f"run_dir={tmp_path}/{name}"], device="cpu")

    result = run("iodine", "iodine")
    records = [json.loads(line) for line in open(tmp_path / "iodine" / "metrics.jsonl")]
    aris = [r["train/ari"] for r in records if "train/loss" in r]
    assert len(aris) == 2 and all(np.isfinite(aris))
    assert result["model"].optimizer.adam.param_groups[0]["lr"] == cfg.ocr.learning.lr
    _, mcfg = configs(VARIANTS["mae"])
    scaled = pretraining_config(mcfg.ocr, 24)
    assert scaled.learning.lr == mcfg.ocr.learning.lr * 24 / 256
    assert dataclasses.replace(scaled, learning=mcfg.ocr.learning) == mcfg.ocr
    assert pretraining_config(cfg.ocr, 24) is cfg.ocr
    lrs = {g["lr"] for g in run("mae", "mae")["model"].optimizer.adam.param_groups}
    assert lrs == {mcfg.ocr.learning.lr * 2 / 256}


def test_recorded_draws_replay_the_step():
    """Without given noise each loss draws from the OCR's generator and
    records the draw in a given dict; two OCRs of one seed take the same
    step, and a third replays it from the recorded draw."""
    _, cfg = configs(VARIANTS["iodine"])
    obs = obs_of(cfg, B)
    a, b, c = (create_ocr(cfg.ocr, cfg.env, seed=3, device="cpu") for _ in range(3))
    recorded = {}
    ma = a.update(obs, None, 0, noise=recorded)
    mb = b.update(obs, None, 0)
    c.generator.manual_seed(99)
    mc = c.update(obs, None, 0, noise=dict(recorded))
    assert recorded["eps"].shape == (cfg.ocr.num_iterations, B, cfg.ocr.num_slots,
                                     cfg.ocr.slot_size)
    for m in (mb, mc):
        assert float(m["loss"]) == float(ma["loss"])
    for p, q, r in zip(a.module.parameters(), b.module.parameters(), c.module.parameters()):
        assert torch.equal(p, q) and torch.equal(p, r)
