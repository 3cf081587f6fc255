"""The RL slice's other OCRs against their JAX modules, on the same inputs,
the same weights (through utils.convert.ocr_from_flax) and, for IODINE, the
same numpy noise (JAX's normal draw replaced by the test's array):

- NatureCNN as a vector, as its 4x4 map and as its 2x2 map; MultipleCNN
  with K = 3 (64x64 images: the Nature CNN needs at least 36);
- the VAE as its mean and as its 4x4 map; MAE ``tiny``
  with patch 4 at obs 16, patch tokens and CLS; IODINE narrow (slots of 8,
  2 iterations, obs 16) with its masks, its decoder, LSTM cell and
  standardisation;
- the committed encoders at full width: artifacts/encoders/vae.ckpt (both
  representations) and iodine.ckpt (IODINE-large, 5 iterations), batch 2
  of env frames, each package loading the file with its own reader;
- every OCR's whole tree (decoders included) loading into the port's
  ``build_module(..., decoder=True)``, each OCR config against its YAML,
  and each OCR's pretraining step (held against JAX in
  test_torch_pretrain.py).

Tolerances, relative to the output's scale (``close``: max |got - want| <=
tol x max(max |want|, 1e-2)): the convolution stacks, the ViT, IODINE's
decoder, LSTM cell and standardisation 1e-5 (fp32 sums in other orders);
IODINE's slots and masks 2e-5 at narrow width; at full width 5e-5 for the
slots and 2e-4 for the masks: its refinement carries each iteration's
rounding into the next through the inner gradients and the LSTM. The
full-width bounds come from a float64 run of the port on the same weights
and noise, from which each fp32 side lies about as far as from the other
(on these inputs: slots 2.0e-5 and 2.5e-5 of their scale, masks 1.2e-4
each; ``test_committed_iodine_matches_jax`` holds all three pairs).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from ocrl_tpu.config import compose
from ocrl_tpu.models import build_spec
from ocrl_tpu.models import iodine as jiodine
from ocrl_tpu.poolings import get_ocr as jget_ocr

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.models import build_module, create_ocr, dims
from ocrl_tpu_torch.models import iodine as tiodine
from ocrl_tpu_torch.utils.checkpoint import get_ocr
from ocrl_tpu_torch.utils.convert import ocr_from_flax

ROOT = Path(__file__).resolve().parents[1]
BASE = ["pooling=transformer", "sb3=ppo", "sb3_acnet=mlp", "env=target-N4C4S3S1"]
SMALL = ["env.obs_size=16"]
VARIANTS = {
    "naturecnn": ["ocr=naturecnn"],
    "naturecnn-feat4": ["ocr=naturecnn", "ocr.use_cnn_feat=True"],
    "naturecnn-feat2": ["ocr=naturecnn", "ocr.use_cnn_feat=True", "ocr.cnn_feat_size=2"],
    "multiple_cnn": ["ocr=multiple_cnn", "ocr.num_modules=3"],
    "vae": ["ocr=vae"] + SMALL,
    "vae-feat": ["ocr=vae", "ocr.use_cnn_feat=True"] + SMALL,
    "mae": ["ocr=mae", "ocr.vit_size=tiny", "ocr.patch_size=4"] + SMALL,
    "mae-cls": ["ocr=mae", "ocr.vit_size=tiny", "ocr.patch_size=4",
                "ocr.return_cls=True"] + SMALL,
    "iodine": ["ocr=iodine_large", "ocr.slot_size=8", "ocr.num_iterations=2"] + SMALL,
}
OCR_FILES = ["naturecnn", "multiple_cnn", "vae", "mae", "iodine_large"]
TOL, IODINE_TOL, FLOOR = 1e-5, 2e-5, 1e-2
IODINE_FULL_TOL = (5e-5, 2e-4)      # slots, masks


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def configs(argv):
    """(the JAX config, the port's) of the same overrides."""
    return (compose("train_sb3", BASE + argv),
            tcfg.compose(tcfg.TrainSB3Config(), BASE + argv))


def images(n, size, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def frames(cfg, n):
    """n env frames of the port's env, as floats in [0, 1]."""
    return np.stack([make_env(cfg, 100 + i).reset() for i in range(n)]).astype(np.float32) / 255


def close(got, want, tol=TOL, floor=FLOOR):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err:.3e} > {tol} x {scale:.3e}"
    return err / scale


def iodine_noise(ocr, B, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (ocr.num_iterations, B, ocr.num_slots, ocr.slot_size)).astype(np.float32)


def patch_normal(monkeypatch, noise):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))


def jax_module(cfg, obs, method=None):
    """The JAX OCR module and its parameters (numpy), initialised on obs;
    with ``method="loss"`` the whole tree, decoders included."""
    module = build_spec(cfg.ocr, cfg.env).module
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    kwargs = {} if method is None else {"method": method}
    params = module.init(rngs, obs, **kwargs)["params"]
    return module, jax.tree.map(np.asarray, params)


def port_module(cfg, params, decoder=False):
    module = build_module(cfg.ocr, cfg.env, decoder=decoder)
    module.load_state_dict(ocr_from_flax(params))
    return module.eval()


@pytest.mark.parametrize("variant", VARIANTS)
def test_ocr_matches_jax(variant, monkeypatch):
    jcfg, cfg = configs(VARIANTS[variant])
    obs = images(2, jcfg.env.obs_size)
    iodine = cfg.ocr.name == "Iodine"
    noise = iodine_noise(cfg.ocr, 2) if iodine else None
    if iodine:
        patch_normal(monkeypatch, noise)
    jm, params = jax_module(jcfg, obs)
    want = jm.apply({"params": params}, obs, rngs={"noise": jax.random.PRNGKey(2)})
    tm = port_module(cfg, params)
    got = tm(torch.from_numpy(obs), noise=None if noise is None else torch.from_numpy(noise))
    close(got, want, IODINE_TOL if iodine else TOL)
    spec = build_spec(jcfg.ocr, jcfg.env)
    assert dims(cfg.ocr, cfg.env) == (spec.rep_dim, spec.num_slots)
    rep_dim, num_slots = spec.rep_dim, spec.num_slots
    assert got.shape == ((2, rep_dim) if num_slots == 1 else (2, num_slots, rep_dim))


def test_iodine_masks_match_jax(monkeypatch):
    jcfg, cfg = configs(VARIANTS["iodine"])
    obs = images(3, 16, seed=1)
    noise = iodine_noise(cfg.ocr, 3, seed=4)
    patch_normal(monkeypatch, noise)
    jm, params = jax_module(jcfg, obs)
    want_slots, want_masks = jm.apply({"params": params}, obs, True,
                                      rngs={"noise": jax.random.PRNGKey(2)})
    tm = port_module(cfg, params)
    got_slots, got_masks = tm(torch.from_numpy(obs), noise=torch.from_numpy(noise),
                              with_masks=True)
    close(got_slots, want_slots, IODINE_TOL)
    close(got_masks, want_masks, IODINE_TOL)
    assert torch.allclose(got_masks.sum(1), torch.ones(()), atol=1e-6)


def test_iodine_decoder_matches_jax():
    slots = np.random.default_rng(5).standard_normal((2, 3, 8)).astype(np.float32)
    jm = jiodine.Decoder(dim_hidden=16, n_layers=3, kernel_size=3, img_size=12)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), slots)["params"])
    want = jm.apply({"params": params}, slots)
    tm = tiodine.Decoder(8, 16, 3, 3, 12)
    state = ocr_from_flax({"decoder": params})
    tm.load_state_dict({k[len("decoder."):]: v for k, v in state.items()})
    got = tm(torch.from_numpy(slots))
    for g, w in zip(got, want):
        close(g, w)


def test_lstm_cell_matches_flax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 24)).astype(np.float32)
    carry = tuple(rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    jm = fnn.OptimizedLSTMCell(16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), carry, x)["params"])
    (want_c, want_h), want_out = jm.apply({"params": params}, carry, x)
    tm = tiodine.LSTMCell(24, 16)
    state = ocr_from_flax({"refine": {"lstm": params}})
    tm.load_state_dict({k[len("refine.lstm."):]: v for k, v in state.items()})
    (c, h), out = tm(tuple(torch.from_numpy(t) for t in carry), torch.from_numpy(x))
    for g, w in ((c, want_c), (h, want_h), (out, want_out)):
        close(g, w)


@pytest.mark.parametrize("shape", [(2, 3, 8), (2, 3, 5, 5, 3)], ids=["posterior", "maps"])
def test_layernorm_stat_matches_jax(shape):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32) * 3 + 1
    close(tiodine.layernorm_stat(torch.from_numpy(x)), jiodine._layernorm_stat(x))


@pytest.mark.parametrize("variant", ["naturecnn-feat2", "multiple_cnn", "vae", "mae",
                                     "iodine"])
def test_whole_ocr_tree_loads(variant, monkeypatch):
    """The JAX OCR's whole parameter tree (as ``loss`` creates it:
    decoders included) is exactly the port's whole module."""
    jcfg, cfg = configs(VARIANTS[variant])
    obs = images(2, jcfg.env.obs_size)
    if cfg.ocr.name == "Iodine":
        patch_normal(monkeypatch, iodine_noise(cfg.ocr, 2))
    _, params = jax_module(jcfg, obs, method="loss")
    state = ocr_from_flax(params)
    module = build_module(cfg.ocr, cfg.env, decoder=True)
    assert set(state) == set(module.state_dict())
    module.load_state_dict(state)


@pytest.mark.parametrize("variant", ["vae", "vae-feat"])
def test_committed_vae_matches_jax(variant):
    argv = [a for a in VARIANTS[variant] if a not in SMALL] + [
        f"pooling.ocr_checkpoint.local_file={ROOT}/artifacts/encoders/vae.ckpt"]
    jcfg, cfg = configs(argv)
    jocr, jpre = jget_ocr(jcfg.ocr, jcfg.env, jcfg.pooling.ocr_checkpoint, seed=0)
    ocr, pre = get_ocr(cfg.ocr, cfg.env, cfg.pooling.ocr_checkpoint, 0, "cpu")
    assert jpre and pre
    obs = frames(cfg.env, 2)
    want = jocr.spec.module.apply({"params": jocr.params}, obs)
    close(ocr.module.eval()(torch.from_numpy(obs)), want)


def test_committed_iodine_matches_jax(monkeypatch):
    """IODINE-large from artifacts/encoders/iodine.ckpt, batch 2 of env
    frames, 5 iterations: slots and masks against JAX, and both against the
    port in float64 on the same weights and noise."""
    argv = ["ocr=iodine_large",
            f"pooling.ocr_checkpoint.local_file={ROOT}/artifacts/encoders/iodine.ckpt"]
    jcfg, cfg = configs(argv)
    jocr, _ = jget_ocr(jcfg.ocr, jcfg.env, jcfg.pooling.ocr_checkpoint, seed=0)
    ocr, _ = get_ocr(cfg.ocr, cfg.env, cfg.pooling.ocr_checkpoint, 0, "cpu")
    obs = frames(cfg.env, 2)
    noise = iodine_noise(cfg.ocr, 2, seed=9)
    patch_normal(monkeypatch, noise)
    want = jocr.spec.module.apply({"params": jocr.params}, obs, True,
                                  rngs={"noise": jax.random.PRNGKey(0)})
    module = ocr.module.eval()
    with torch.no_grad():       # the frozen OCR's path
        got = module(torch.from_numpy(obs), noise=torch.from_numpy(noise), with_masks=True)
        ref = module.double()(torch.from_numpy(obs).double(),
                              noise=torch.from_numpy(noise).double(), with_masks=True)
    for g, w, r, tol in zip(got, want, ref, IODINE_FULL_TOL):
        r = r.numpy()
        close(g, w, tol)
        close(g, r, tol)
        close(w, r, tol)


def test_iodine_grad_modes_agree():
    """The forward opens autograd where its caller has none: under
    no_grad and inference_mode it gives the slots it gives with autograd
    on, detached; with autograd on, the slots carry a graph to the
    parameters (the OCR trained end to end)."""
    _, cfg = configs(VARIANTS["iodine"])
    torch.manual_seed(0)
    module = build_module(cfg.ocr, cfg.env).eval()
    obs = torch.from_numpy(images(2, 16, seed=2))
    noise = torch.from_numpy(iodine_noise(cfg.ocr, 2))
    with torch.no_grad():
        frozen = module(obs, noise=noise)
    with torch.inference_mode():
        served = module(obs.clone(), noise=noise.clone())
    e2e = module(obs, noise=noise)
    assert not frozen.requires_grad and not served.requires_grad and e2e.requires_grad
    assert torch.equal(frozen, served)
    torch.testing.assert_close(e2e.detach(), frozen, rtol=0, atol=1e-6)
    grads = torch.autograd.grad(e2e.sum(), list(module.parameters()), allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("variant", ["naturecnn", "multiple_cnn", "vae", "mae", "iodine"])
def test_other_ocrs_build_and_refuse_pretraining(variant):
    """create_ocr builds each OCR (on the CPU when asked) with its
    optimizer, and each takes a pretraining step: VAE, MAE and IODINE move
    their parameters and report finite metrics (held against JAX in
    test_torch_pretrain.py); NatureCNN and MultipleCNN have no pretraining
    loss (they train end to end), so their step returns {} and leaves them
    as they are, as JAX's does. save() carries the optimizer state."""
    _, cfg = configs(VARIANTS[variant])
    ocr = create_ocr(cfg.ocr, cfg.env, seed=0, device="cpu")
    obs = np.random.default_rng(0).integers(
        0, 256, (2, cfg.env.obs_size, cfg.env.obs_size, 3), dtype=np.uint8)
    start = {k: v.clone() for k, v in ocr.module.state_dict().items()}
    metrics = ocr.update(obs, None, 0)
    moved = [k for k, v in ocr.module.state_dict().items() if not torch.equal(v, start[k])]
    if "cnn" in variant:
        assert metrics == {} and ocr.get_loss(obs) == {} and not moved
    else:
        assert "loss" in metrics and moved
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert set(ocr.get_loss(obs)) == set(metrics) - {"norm"}
    ckpt = ocr.save()
    assert set(ckpt) == {"ocr_module_state_dict", "ocr_opt_state_dict"}
    assert ckpt["ocr_opt_state_dict"]["count"] == 1


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("name", OCR_FILES)
def test_ocr_config_matches_the_yaml(name):
    """Each OCR group's dataclass holds its YAML, read by the port's own
    reader and by the JAX compose."""
    port = _plain(dataclasses.asdict(tcfg.GROUPS["ocr"][name]))
    assert port == _plain(tcfg.compose_file(tcfg.CONFIG_DIR / "ocr" / f"{name}.yaml"))
    assert port == _plain(compose("train_sb3", [f"ocr={name}"] + BASE)
                          .ocr.to_dict())
