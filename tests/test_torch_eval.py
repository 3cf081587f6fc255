"""The evaluation slice against the JAX package, at a small width (obs 16,
vocab 32, d 32, 2 decoder blocks): the ARI, SLATE's loss with masks, the
KV-cached decode, greedy generation, the broadcast decoder, the
get_ari_mse loop and its command line against JAX's on a gzip-chunked
file, on the same weights (utils.convert) and the same draws.

Tolerances, and why:
- ARI within 1e-6 and label maps exactly: the contingency counts are exact
  integers in fp32 on both sides, and only the final fp32 formula rounds;
- one attention step or cached decoder step 1e-5 (one layer of fp32 work);
- SLATE's loss metrics 1e-5 relative (as in test_torch_models.py);
- the broadcast decoder 1e-4 relative (conv stacks summed in another order);
- greedy tokens exactly, up to each row's first position where JAX's two
  largest logits lie within 1e-4 of each other (there rounding may pick
  either, and every later token of the row follows from it); the images
  of the rows that compare in full 1e-4 relative (the dVAE's conv stack);
- the entry's ARI within 1e-6 and MSE 1e-5 relative, as the loss.
"""

import json

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.config import compose
from ocrl_tpu.models import create_ocr as jcreate_ocr
from ocrl_tpu.models import transformer as jtf
from ocrl_tpu.models.base import normalize_obs as jnormalize
from ocrl_tpu.models.dvae import BroadCastDecoder as JBroadCastDecoder
from ocrl_tpu.utils import metrics as jmetrics
from ocrl_tpu.utils.checkpoint import save_checkpoint

import get_ari_mse as jget_ari_mse
from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import get_ari_mse as tget_ari_mse
from ocrl_tpu_torch.get_ari_mse import batches_of, evaluate, evaluate_arrays
from ocrl_tpu_torch.models import transformer as ttf
from ocrl_tpu_torch.models.common import conv_nhwc
from ocrl_tpu_torch.models.dvae import BroadCastDecoder
from ocrl_tpu_torch.utils import metrics
from ocrl_tpu_torch.utils.checkpoint import get_ocr

from test_torch_models import (LAYER, STACK, TINY, _slate_noise, close, load, rand,
                               small_train_modules)

ARI_TOL = 1e-6
GAP = 1e-4


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def painted(B, size, K=5, seed=0):
    """uint8 observations [B, size, size, 3] painted with K - 1 axis-aligned
    squares over a background, and their masks [B, K, size, size, 1], the
    background last (a later square covers an earlier one)."""
    rng = np.random.default_rng(seed)
    obs = np.empty((B, size, size, 3), np.uint8)
    masks = np.zeros((B, K, size, size, 1), np.uint8)
    for b in range(B):
        label = np.full((size, size), K - 1)
        obs[b] = rng.integers(0, 256, 3)
        for k in range(K - 1):
            h, w = rng.integers(size // 4, size // 2 + 1, 2)
            y, x = rng.integers(0, size - h + 1), rng.integers(0, size - w + 1)
            label[y:y + h, x:x + w] = k
            obs[b, y:y + h, x:x + w] = rng.integers(0, 256, 3)
        masks[b, ..., 0] = label[None] == np.arange(K)[:, None, None]
    return obs, masks


# -- ARI ------------------------------------------------------------------------

def _labelings(case):
    rng = np.random.default_rng(1)
    if case == "random":
        return rng.integers(0, 4, (3, 64)), rng.integers(0, 6, (3, 64)), 4, 6
    if case == "degenerate":      # one cluster on each side: 1.0
        return np.zeros((2, 64), np.int64), np.full((2, 64), 2), 4, 6
    if case == "identical":
        ids = rng.integers(0, 5, (2, 64))
        return ids, ids, 5, 5
    if case == "one_pixel":       # n = 1: comb2(n) = 0, the clamp to 1
        return np.array([[1]]), np.array([[0]]), 3, 3
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "degenerate", "identical", "one_pixel"])
def test_adjusted_rand_index_matches_jax(case):
    true_ids, pred_ids, kt, kp = _labelings(case)
    want = np.asarray(jmetrics.adjusted_rand_index(jnp.asarray(true_ids),
                                                   jnp.asarray(pred_ids), kt, kp))
    got = metrics.adjusted_rand_index(torch.from_numpy(true_ids),
                                      torch.from_numpy(pred_ids), kt, kp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ARI_TOL)
    if case in ("degenerate", "identical"):
        np.testing.assert_array_equal(got.numpy(), 1.0)


@pytest.mark.parametrize("ties", [False, True])
def test_calculate_ari_and_label_maps_match_jax(ties):
    """Label maps from masks exactly, ties included (both frameworks take
    the first largest mask), and the per-sample ARI within 1e-6."""
    rng = np.random.default_rng(2)
    true = rng.random((3, 4, 8, 8, 1)).astype(np.float32)
    pred = rng.random((3, 6, 8, 8, 1)).astype(np.float32)
    if ties:      # quantised: many pixels hold equal largest values
        true, pred = np.round(true * 2) / 2, np.round(pred * 2) / 2
        pred[0] = 0.0                           # a sample of all-tied pixels
    for masks in (true, pred):
        want = np.asarray(jnp.argmax(jnp.asarray(masks).reshape(3, masks.shape[1], -1),
                                     axis=1))
        np.testing.assert_array_equal(metrics.mask_labels(torch.from_numpy(masks)).numpy(),
                                      want)
    want = np.asarray(jmetrics.calculate_ari(jnp.asarray(true), jnp.asarray(pred)))
    got = metrics.calculate_ari(torch.from_numpy(true), torch.from_numpy(pred))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ARI_TOL)


def test_foreground_ari_ignores_attentions_below_one():
    """The JAX rule, reproduced: the predicted masks are the attentions times
    the foreground with the foreground itself last, so in a foreground pixel
    the last channel (1.0) wins the argmax unless an attention is exactly
    1.0. Two attention fields below saturation give the same ARI; a one-hot
    field changes it. JAX scores all three alike within 1e-6."""
    jm, p, tm = small_train_modules()
    _, masks = painted(4, 16, seed=3)
    masks = masks.astype(np.float32)
    rng = np.random.default_rng(4)
    fields = [torch.softmax(torch.from_numpy(rng.standard_normal((4, 256, 3))
                                             .astype(np.float32)) * s, -1) for s in (1, 3)]
    fields.append(torch.nn.functional.one_hot(fields[1].argmax(-1), 3).float())
    aris = []
    for attns in fields:
        got = tm._ari(attns, torch.from_numpy(masks))
        want = jm.apply({"params": p}, jnp.asarray(attns.numpy()), jnp.asarray(masks),
                        method="_ari")
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ARI_TOL)
        aris.append(float(got))
    assert aris[0] == aris[1]
    assert abs(aris[2] - aris[0]) > 1e-3


# -- SLATE's loss with masks ------------------------------------------------------

@pytest.mark.parametrize("bcdec", [False, True])
def test_slate_loss_with_masks_matches_jax(bcdec, monkeypatch):
    """The eval-mode loss with masks: ``ari`` within 1e-6, every other metric
    1e-5 relative, on the same draws. With ``use_bcdec`` the metrics are
    the broadcast decoder's ``mse`` (and ``loss``) and the port draws only
    the slot noise."""
    extra = [("ocr.learning.dropout", 0.0)] + ([("ocr.use_bcdec", True)] if bcdec else [])
    jm, p, tm = small_train_modules(extra)
    obs_u8, masks = painted(2, 16, seed=5)
    obs = obs_u8.astype(np.float32) / 255.0
    noise = _slate_noise(2, monkeypatch, 51)
    if bcdec:
        noise = {"slots": noise["slots"]}
    _, want = jm.apply({"params": p}, obs, masks.astype(np.float32), 0, False,
                       method="loss", rngs={k: jax.random.PRNGKey(i) for i, k in
                                            enumerate(("noise", "noise2", "dropout"))})
    with torch.no_grad():
        _, got = tm.loss(torch.from_numpy(obs), torch.from_numpy(masks).float(), 0, False,
                         noise=noise)
    assert set(got) == set(want) and "ari" in got
    assert set(noise) == ({"slots"} if bcdec else {"soft", "ids", "slots"})
    np.testing.assert_allclose(float(got["ari"]), float(want["ari"]), rtol=0, atol=ARI_TOL)
    for key in set(want) - {"ari"}:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


# -- the cached decode path -------------------------------------------------------

def test_cached_attention_steps_match_jax():
    """kv + step_with_kv against a fixed source; step_cached token by token,
    writing the caches at t and cutting the positions after t."""
    T = 6
    jm = jtf.MultiHeadAttention(16, 4, gain=0.5)
    p = jm.init(jax.random.PRNGKey(60), rand(2, 3, 16), rand(2, 3, 16), rand(2, 3, 16))
    p = p["params"]
    tm = load(ttf.MultiHeadAttention(16, 4, 0.0, 0.5), p,
              ("ocr_module", "tfdec", "blocks_0", "self_attn"),
              "ocr_module.tfdec.blocks.0.self_attn.")
    src, q_t = rand(2, 3, 16, seed=61), rand(2, 16, seed=62)
    jk, jv = jm.apply({"params": p}, src, method="kv")
    tk, tv = tm.kv(torch.from_numpy(src))
    close(tk, jk, LAYER)
    close(tv, jv, LAYER)
    close(tm.step_with_kv(torch.from_numpy(q_t), tk, tv),
          jm.apply({"params": p}, q_t, jk, jv, method="step_with_kv"), LAYER)

    jkc = jvc = jnp.zeros((2, 4, T, 4))
    tkc, tvc = torch.zeros(2, 4, T, 4), torch.zeros(2, 4, T, 4)
    for t in range(T):
        x = rand(2, 16, seed=63 + t)
        want, jkc, jvc = jm.apply({"params": p}, x, jkc, jvc, t, method="step_cached")
        with torch.no_grad():
            got = tm.step_cached(torch.from_numpy(x), tkc, tvc, t, torch.arange(T) > t)
        close(got, want, LAYER)
        close(tkc, jkc, LAYER)
        close(tvc, jvc, LAYER)


def test_decoder_step_matches_jax():
    """The decoder's make_caches, cross_kvs and step (every block, the final
    LayerNorm) token by token, outputs and caches 1e-5."""
    T = 6
    x, enc = rand(2, T, 16, seed=70), rand(2, 3, 16, seed=71)
    jdec = jtf.TransformerDecoder(2, T, 16, 2, 0.0)
    p = jdec.init(jax.random.PRNGKey(72), x, enc)["params"]
    tdec = load(ttf.TransformerDecoder(2, T, 16, 2, 0.0), p, ("ocr_module", "tfdec"),
                "ocr_module.tfdec.")
    jks, jvs = jdec.apply({"params": p}, enc, method="cross_kvs")
    jkc, jvc = jdec.apply({"params": p}, 2, method="make_caches")
    with torch.no_grad():
        tks, tvs = tdec.cross_kvs(torch.from_numpy(enc))
        tkc, tvc = tdec.make_caches(2)
        assert tuple(tkc.shape) == jkc.shape == (2, 2, 2, T, 8)
        close(tks, jks, LAYER)
        for t in range(T):
            want, jkc, jvc = jdec.apply({"params": p}, x[:, t], jkc, jvc, t, jks, jvs,
                                        method="step")
            close(tdec.step(torch.from_numpy(x[:, t]), tkc, tvc, t, tks, tvs), want, LAYER)
            close(tkc, jkc, LAYER)
            close(tvc, jvc, LAYER)


def test_cached_decode_equals_teacher_forcing():
    """The port's greedy decode agrees with its own teacher-forced decoder
    re-run on the tokens it produced (the exactness of the cache path;
    tests/test_slate.py:49-71 for the JAX package)."""
    _, _, tm = small_train_modules()
    slots = torch.from_numpy(rand(3, 3, 32, seed=80))
    tokens = tm.gen_tokens(slots)
    assert tokens.shape == (3, 16) and tokens.dtype == torch.int64
    with torch.no_grad():
        pred = tm.teacher_forced_logits(slots, tokens).argmax(-1)
    assert torch.equal(pred, tokens)


def _jax_teacher_logits(mdl, slots, tokens):
    B = tokens.shape[0]
    z_emb = mdl.dictionary(tokens)
    z_emb = jnp.concatenate([jnp.broadcast_to(mdl.bos, (B, 1, z_emb.shape[-1])), z_emb], 1)
    z_emb = mdl.z_pos(z_emb, deterministic=True)
    return mdl.out(mdl.tfdec(z_emb[:, :-1], mdl.slotproj(slots), deterministic=True))


def first_near_ties(logits, gap=GAP):
    """Each row's first position whose two largest logits lie within
    ``gap``, or the row length when there is none."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) < gap
    return np.where(near.any(-1), near.argmax(-1), logits.shape[1])


def test_gen_tokens_and_imgs_match_jax():
    """Greedy tokens against JAX's scan on the same weights and slots:
    exactly, up to each row's first near-tie of JAX's logits; at least 3 of
    the 4 rows compare in full; their images 1e-4 relative."""
    jm, p, tm = small_train_modules()
    slots = rand(4, 3, 32, seed=81)
    want = np.asarray(jm.apply({"params": p}, slots, method="gen_tokens"))
    logits = np.asarray(jm.apply({"params": p}, slots, want, method=_jax_teacher_logits))
    upto = first_near_ties(logits)
    got = tm.gen_tokens(torch.from_numpy(slots)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(got[b, :upto[b]], want[b, :upto[b]], err_msg=str(b))
    full = np.flatnonzero(upto == want.shape[1])
    assert len(full) >= 3, upto
    want_imgs = np.asarray(jm.apply({"params": p}, slots, method="gen_imgs"))
    got_imgs = tm.gen_imgs(torch.from_numpy(slots))
    assert tuple(got_imgs.shape) == (4, 16, 16, 3)
    close(got_imgs[full], want_imgs[full], STACK)


def test_sample_arrays_shapes():
    """sample_arrays: (obs, dVAE reconstruction, generated image, blended
    attentions) and, with use_bcdec, (obs, broadcast image, attentions)."""
    obs = torch.from_numpy(painted(2, 16, seed=6)[0].astype(np.float32) / 255.0)
    for bcdec, n in ((False, 4), (True, 3)):
        _, _, tm = small_train_modules([("ocr.use_bcdec", True)] if bcdec else [])
        arrays = tm.sample_arrays(obs, torch.Generator().manual_seed(0))
        assert len(arrays) == n
        assert all(tuple(a.shape) == (2, 16, 16, 3) for a in arrays[:-1])
        assert tuple(arrays[-1].shape) == (2, 3, 16, 16, 3)
        assert all(torch.isfinite(a).all() for a in arrays)


# -- the broadcast decoder --------------------------------------------------------

def test_broadcast_decoder_matches_naive_conv_and_jax():
    """The restructured first conv (slot term on a 5x5 grid, tiled, plus
    conv1(pos) - bias) against the naive conv of the broadcast input, and
    the whole decoder against JAX, 1e-4 relative."""
    jdec = JBroadCastDecoder(obs_size=16, obs_channels=3, hidden_size=8, slot_size=12)
    slots = rand(2, 3, 12, seed=90)
    p = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(91), slots)["params"])
    # non-zero biases, so that "- bias" and the positions' bias are held too
    p["conv1"]["bias"] = rand(8, seed=92)
    p["pos_emb"]["channels_map"]["bias"] = rand(12, seed=93)
    p["rest"]["layers_2"]["bias"] = rand(4, seed=94)
    tm = load(BroadCastDecoder(16, 3, 8, 12), p, ("ocr_module", "bcdec"),
              "ocr_module.bcdec.")
    t_slots = torch.from_numpy(slots)
    with torch.no_grad():
        got = tm(t_slots)
        grid = t_slots.reshape(6, 1, 1, 12).expand(6, 16, 16, 12)
        x = torch.relu(conv_nhwc(tm.conv1, tm.pos_emb(grid)))
        for layer in tm.rest:
            x = conv_nhwc(layer, x) if isinstance(layer, torch.nn.Conv2d) else layer(x)
        naive_masks = torch.softmax(x[..., 3:].reshape(2, 3, 16, 16, 1), dim=1)
        naive = (x[..., :3].reshape(2, 3, 16, 16, 3) * naive_masks).sum(1)
    close(got, naive.numpy(), STACK)
    close(got, jdec.apply({"params": p}, slots), STACK)


# -- the entry ----------------------------------------------------------------------

SMALL = [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
         ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
         ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
         ("ocr.dvae.d_model", 32), ("ocr.tfdec.num_dec_blocks", 2),
         ("ocr.tfdec.num_dec_heads", 2)]


def port_eval_config(bcdec=False, **fields):
    """GetAriMseConfig at SMALL's sizes (its dataset for JAX's env)."""
    cfg = tcfg.GetAriMseConfig()
    for path, value in SMALL + ([("ocr.use_bcdec", True)] if bcdec else []):
        cfg = tcfg.replace(cfg, path.replace("env.", "dataset.", 1), value)
    for path, value in fields.items():
        cfg = tcfg.replace(cfg, path, value)
    return cfg


def _jax_eval_loop(jocr, batches, with_gen):
    """The loop of the repo-root get_ari_mse.py:42-78, call for call."""
    module = jocr.spec.module

    def gen_mse(params, obs, rng):
        slots, _ = module.apply({"params": params}, obs, rngs=jocr._rngs_for(rng),
                                method="get_slots")
        recon = module.apply({"params": params}, slots, method="gen_imgs")
        return jnp.sum((obs - recon) ** 2) / obs.shape[0]

    gen_mse_fn = jax.jit(gen_mse) if with_gen else None
    aris, mses = [], []
    eval_key = jax.random.PRNGKey(0)
    for batch in batches:
        eval_key, batch_key = jax.random.split(eval_key)
        m = jocr.get_loss(batch["obss"], batch["masks"])
        aris.append(float(np.asarray(m["ari"])))
        if gen_mse_fn is not None:
            mses.append(float(np.asarray(gen_mse_fn(jocr.params, jnormalize(batch["obss"]),
                                                    batch_key))))
        else:
            mses.append(float(np.asarray(m["mse"] if "mse" in m else m["dvae_mse"])))
    return {"ari": float(np.mean(aris)), "mse": float(np.mean(mses))}


def _gzip_file(path, masks: bool) -> None:
    """8 training and 8 validation painted scenes at obs 16, gzip and
    shuffle at h5py's automatic chunks; with their masks or without."""
    with h5py.File(path, "w") as f:
        for split, seed in (("TrainingSet", 3), ("ValidationSet", 7)):
            obs, mask = painted(8, 16, seed=seed)
            group = f.create_group(split)
            group.create_dataset("obss", data=obs, compression="gzip", shuffle=True)
            if masks:
                group.create_dataset("masks", data=mask, compression="gzip", shuffle=True)


def test_cli_matches_the_jax_cli_on_a_chunked_file(tmp_path, monkeypatch):
    """``python -m ocrl_tpu_torch.get_ari_mse``'s main(argv, device="cpu")
    against the repo-root get_ari_mse.main (its config composed from the
    same argv; the decorator's compilation cache left out) on a
    gzip-chunked file, with the same draws (as
    test_evaluate_matches_the_jax_loop feeds them: JAX's patched by shape,
    the port's given to its evaluate): JAX's run builds SLATE from seed 0,
    and the checkpoint JAX writes of that OCR is the one the port loads.
    ARI within ARI_TOL, MSE 1e-5 relative, the same keys logged at step 0.
    A file without masks raises KeyError on both sides."""
    rng = np.random.default_rng(100)
    e = [rng.exponential(size=(4 * 16, 32)).astype(np.float32) for _ in range(2)]
    slot_draws = [rng.standard_normal((4, 3, 32)).astype(np.float32) for _ in range(2)]
    calls = {"exponential": 0, "normal": 0}
    exponential0, normal0 = jax.random.exponential, jax.random.normal

    def exponential(key, shape=(), dtype=jnp.float32):
        if tuple(shape) != e[0].shape:
            return exponential0(key, shape, dtype)
        calls["exponential"] += 1
        return jnp.asarray(e[(calls["exponential"] - 1) % 2])

    def normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) != slot_draws[0].shape:
            return normal0(key, shape, dtype)
        calls["normal"] += 1                   # the loss's trace, then gen_mse's
        return jnp.asarray(slot_draws[calls["normal"] - 1])

    _gzip_file(tmp_path / "ds.h5", masks=True)
    argv = ["ocr=slate", "dataset=random-N5C4S4S2", f"dataset.datadir={tmp_path}/ds.h5",
            "batch_size=4"] + [f"{k.replace('env.', 'dataset.', 1)}={v}" for k, v in SMALL]
    built, jax_get_ocr = [], jget_ari_mse.get_ocr

    def get_ocr_kept(*args, **kwargs):          # built once, for both of JAX's runs
        if not built:
            built.append(jax_get_ocr(*args, **kwargs)[0])
        return built[0], False

    monkeypatch.setattr(jget_ari_mse, "get_ocr", get_ocr_kept)
    monkeypatch.setattr(jax.random, "exponential", exponential)
    monkeypatch.setattr(jax.random, "normal", normal)
    jget_ari_mse.main.__wrapped__(compose("get_ari_mse", argv + [f"run_dir={tmp_path}/jax"]))
    assert calls == {"exponential": 2, "normal": 2}
    save_checkpoint(tmp_path / "model_best.ckpt", built[0].save(), {"step": 0})
    argv.append(f"ocr_checkpoint.local_file={tmp_path}/model_best.ckpt")

    fields = {"soft": torch.from_numpy(-np.log(e[0] + TINY)),
              "ids": torch.from_numpy(-np.log(e[1] + TINY)),
              "slots": torch.from_numpy(slot_draws[0]),
              "gen_slots": torch.from_numpy(slot_draws[1])}
    port_evaluate = tget_ari_mse.evaluate
    monkeypatch.setattr(tget_ari_mse, "evaluate", lambda ocr, batches, seed, **kw: port_evaluate(
        ocr, batches, seed, noise=[dict(fields), dict(fields)], **kw))
    got = tget_ari_mse.main(argv + [f"run_dir={tmp_path}/port"], device="cpu")
    assert len(got["batches"]) == 2

    def logged(side):
        return [json.loads(line) for line in open(tmp_path / side / "metrics.jsonl")]

    (want,), (port,) = logged("jax"), logged("port")
    assert want["_step"] == port["_step"] == 0
    assert set(port) == set(want) == {"_step", "_time", "eval/ari", "eval/mse"}
    np.testing.assert_allclose(port["eval/ari"], want["eval/ari"], rtol=0, atol=ARI_TOL)
    np.testing.assert_allclose(port["eval/mse"], want["eval/mse"], rtol=1e-5)
    assert (got["ari"], got["mse"]) == (port["eval/ari"], port["eval/mse"])

    _gzip_file(tmp_path / "bare.h5", masks=False)
    bare = [a.replace("ds.h5", "bare.h5") for a in argv]
    with pytest.raises(KeyError, match="masks"):
        jget_ari_mse.main.__wrapped__(compose("get_ari_mse", bare + [f"run_dir={tmp_path}/j2"]))
    with pytest.raises(KeyError, match="masks"):
        tget_ari_mse.main(bare + [f"run_dir={tmp_path}/p2"], device="cpu")


@pytest.mark.parametrize("ocr", ["slate", "slotattention"])
def test_evaluate_matches_the_jax_loop(ocr, tmp_path, monkeypatch):
    """Port evaluate() on an OCR loaded from a checkpoint the JAX package
    wrote, against the JAX loop of get_ari_mse.py, on 2 batches of 4 with
    the same draws: ari within 1e-6, mse 1e-5 relative. JAX traces each
    jitted function once with its draws baked in, so both batches use the
    loss draws (two Gumbel fields, the slot noise) and the generation's
    slot noise given here."""
    bcdec = ocr == "slotattention"
    rng = np.random.default_rng(100)
    e = [rng.exponential(size=(4 * 16, 32)).astype(np.float32) for _ in range(2)]
    slot_draws = [rng.standard_normal((4, 3, 32)).astype(np.float32) for _ in range(2)]
    calls = {"exponential": 0, "normal": 0}

    def exponential(key, shape, dtype=jnp.float32):
        calls["exponential"] += 1
        return jnp.asarray(e[(calls["exponential"] - 1) % 2])

    def normal(key, shape, dtype=jnp.float32):
        calls["normal"] += 1          # the loss's trace, then gen_mse's
        return jnp.asarray(slot_draws[calls["normal"] - 1])

    cfg = compose("train_sb3", [f"ocr={ocr}", "env=target-N4C4S3S1", "pooling=transformer",
                                "sb3=ppo", "sb3_acnet=mlp", "ocr.slotattr.fused=auto"]
                  + [f"{k}={v}" for k, v in SMALL])
    jocr = jcreate_ocr(cfg.ocr, cfg.env, seed=0)
    monkeypatch.setattr(jax.random, "exponential", exponential)
    monkeypatch.setattr(jax.random, "normal", normal)
    obs, masks = painted(8, 16, seed=7)
    data = {"obss": obs, "masks": masks}
    want = _jax_eval_loop(jocr, batches_of(data, 4), not bcdec)
    assert calls["normal"] == (1 if bcdec else 2)

    path = tmp_path / "model_best.ckpt"
    save_checkpoint(path, jocr.save(), {"step": 0})
    port = port_eval_config(bcdec, **{"ocr_checkpoint.local_file": str(path)})
    tocr, pretrained = get_ocr(port.ocr, port.dataset, port.ocr_checkpoint, seed=3,
                               device="cpu")
    assert pretrained
    fields = {"soft": torch.from_numpy(-np.log(e[0] + TINY)),
              "ids": torch.from_numpy(-np.log(e[1] + TINY)),
              "slots": torch.from_numpy(slot_draws[0]),
              "gen_slots": torch.from_numpy(slot_draws[1])}
    noise = [dict(fields), dict(fields)]
    got = evaluate(tocr, batches_of(data, 4), 0, noise=noise)
    assert len(got["batches"]) == 2
    np.testing.assert_allclose(got["ari"], want["ari"], rtol=0, atol=ARI_TOL)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5)
    assert all(b["gen_s"] > 0 for b in got["batches"]) != bcdec


def test_main_evaluates_in_batches_and_refuses_what_it_cannot_score(tmp_path):
    """evaluate_arrays() = evaluate() of get_ocr's OCR over batches of
    batch_size, the last one partial; a batch without masks, a background
    not last and an OCR without masks (the VAE) raise, as JAX's entry does;
    IODINE scores (held against JAX in test_torch_pretrain.py)."""
    obs, masks = painted(6, 16, seed=8)
    data = {"obss": obs, "masks": masks}
    cfg = port_eval_config(batch_size=4)
    got = evaluate_arrays(cfg, data, device="cpu")
    ocr, pretrained = get_ocr(cfg.ocr, cfg.dataset, cfg.ocr_checkpoint, cfg.seed, "cpu")
    assert not pretrained
    want = evaluate(ocr, batches_of(data, 4), cfg.seed)
    assert [len(b) for b in batches_of(data, 4)] == [2, 2]
    assert len(got["batches"]) == 2 and (got["ari"], got["mse"]) == (want["ari"], want["mse"])
    assert np.isfinite([got["ari"], got["mse"]]).all()
    with pytest.raises(KeyError, match="masks"):
        evaluate(ocr, [{"obss": obs}])
    with pytest.raises(ValueError, match="bg_mask_idx"):
        evaluate_arrays(port_eval_config(bg_mask_idx=0), data, device="cpu")
    with pytest.raises(ValueError, match="mask-producing"):
        evaluate_arrays(tcfg.GetAriMseConfig(ocr=tcfg.VAEConfig(), dataset=cfg.dataset), data,
                        device="cpu")
    iodine = tcfg.GetAriMseConfig(ocr=tcfg.IodineConfig(slot_size=8, num_iterations=2),
                                  dataset=cfg.dataset, batch_size=4)
    scored = evaluate_arrays(iodine, data, device="cpu")
    assert len(scored["batches"]) == 2 and np.isfinite([scored["ari"], scored["mse"]]).all()
