"""Each module of the port against its JAX counterpart, on the same inputs
and, through utils.convert.from_flax, the same weights.

Tolerances: one layer of fp32 work is held to 1e-5; the slot-attention
recurrence (three GRU iterations) and the encoder stacks to 1e-4 relative,
since the two frameworks sum convolutions and matmuls in other orders and
the recurrence carries those differences on. The training slice's pieces
follow the same rule: the Gumbel-softmax and one attention or FFN layer
1e-5, the dVAE's conv stacks, a decoder block, the decoder and the
cross-entropy 1e-4 relative; SLATE's loss metrics 1e-5 relative (sums of
hundreds of terms of both stacks); the schedules 1e-6 relative (JAX
evaluates them in fp32, the port in float64)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.config import compose
from ocrl_tpu.config.node import StaticConfig
from ocrl_tpu.models import build_spec
from ocrl_tpu.models import common as jcommon
from ocrl_tpu.models.dvae import SlotAttnCNNEncoder as JEncoder
from ocrl_tpu.models.slot_attention import SlotAttention as JSlotAttention
from ocrl_tpu.poolings import create_pooling_module as jpooling
from ocrl_tpu.rl.ac_nets import CustomNetwork as JCustomNetwork

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.models import SLATE_Module
from ocrl_tpu_torch.models.common import (Conv2dBlock, FusedGRUCell,
                                          PositionalEmbedding)
from ocrl_tpu_torch.models.dvae import SlotAttnCNNEncoder
from ocrl_tpu_torch.models.slot_attention import SlotAttention
from ocrl_tpu_torch.poolings import Transformer_Module, create_pooling_module
from ocrl_tpu_torch.rl.ac_nets import CustomNetwork
from ocrl_tpu_torch.utils.convert import from_flax

LAYER = dict(rtol=1e-5, atol=1e-5)
STACK = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def load(module, params, flax_prefix, port_prefix):
    """Convert a flax subtree as it sits in a policy's tree and load it."""
    tree = jax.tree.map(np.asarray, params)
    for key in reversed(flax_prefix):
        tree = {key: tree}
    state = {k[len(port_prefix):]: v for k, v in from_flax(tree).items()}
    module.load_state_dict(state)
    return module.eval()


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_conv2d_block():
    x = rand(2, 8, 8, 3)
    jm = jcommon.Conv2dBlock(16, 5, 1, 2)
    p = jm.init(jax.random.PRNGKey(0), x)["params"]
    tm = load(Conv2dBlock(3, 16, 5, 1, 2), p, ("ocr_module", "enc", "Conv2dBlock_0"),
              "ocr_module.enc.blocks.0.")
    close(tm(torch.from_numpy(x)), jm.apply({"params": p}, x), LAYER)


def test_positional_embedding():
    x = rand(2, 8, 8, 16)
    jm = jcommon.PositionalEmbedding(8, 16)
    p = jm.init(jax.random.PRNGKey(1), x)["params"]
    tm = load(PositionalEmbedding(8, 16), p, ("ocr_module", "enc_pos"),
              "ocr_module.enc_pos.")
    close(tm(torch.from_numpy(x)), jm.apply({"params": p}, x), LAYER)


def test_fused_gru_cell():
    h, x = rand(6, 32, seed=1), rand(6, 32, seed=2)
    jm = jcommon.FusedGRUCell(32)
    p = jm.init(jax.random.PRNGKey(2), h, x)["params"]
    # the zero-initialised biases would hide a swapped bi/bh: perturb them
    p = dict(p, bi=rand(96, seed=3), bh=rand(96, seed=4))
    tm = load(FusedGRUCell(32, 32), p,
              ("ocr_module", "slotattn", "slot_attention", "gru"),
              "ocr_module.slotattn.slot_attention.gru.")
    _, want = jm.apply({"params": p}, h, x)
    close(tm(torch.from_numpy(h), torch.from_numpy(x)), want, LAYER)


def test_cnn_encoder():
    obs = np.random.default_rng(3).random((2, 16, 16, 3)).astype(np.float32)
    jm = JEncoder(16)
    p = jm.init(jax.random.PRNGKey(3), obs)["params"]
    tm = load(SlotAttnCNNEncoder(16), p, ("ocr_module", "enc"), "ocr_module.enc.")
    close(tm(torch.from_numpy(obs)), jm.apply({"params": p}, obs), STACK)


@pytest.mark.parametrize("jax_fused", ["never", "always"])
@pytest.mark.parametrize("port_fused", ["never", "auto"])
def test_slot_attention(jax_fused, port_fused):
    """Both JAX routes (einsum; Pallas sweep in interpret mode) against both
    port routes (einsum; the sweep's plain version on the CPU)."""
    B, N, D_in, S, D = 2, 64, 16, 3, 32
    inputs, slots0 = rand(B, N, D_in, seed=5), rand(B, S, D, seed=6)
    jm = JSlotAttention(3, S, D_in, D, D, 1, fused=jax_fused)
    p = jm.init(jax.random.PRNGKey(4), inputs, slots0)["params"]
    tm = load(SlotAttention(3, S, D_in, D, D, 1, fused=port_fused), p,
              ("ocr_module", "slotattn", "slot_attention"),
              "ocr_module.slotattn.slot_attention.")
    want_slots, want_attn = jm.apply({"params": p}, inputs, slots0)
    got_slots, got_attn = tm(torch.from_numpy(inputs), torch.from_numpy(slots0))
    close(got_slots, want_slots, STACK)
    close(got_attn, want_attn, STACK)


def test_slot_attention_refuses_what_the_kernel_cannot_route():
    x, s = torch.zeros(1, 8, 16), torch.zeros(1, 3, 32)
    with pytest.raises(ValueError, match="ineligible"):
        SlotAttention(1, 3, 16, 32, 32, num_heads=2, fused="always")(x, s)
    with pytest.raises(ValueError, match="fused must be"):
        SlotAttention(1, 3, 16, 32, 32, 1, fused="sometimes")
    # on the CPU more heads take the einsum route under auto
    out, attn = SlotAttention(1, 3, 16, 32, 32, num_heads=2)(x, s)
    assert out.shape == (1, 3, 32) and attn.shape == (1, 8, 3)


SMALL_JAX = ["ocr=slate", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
             "env=target-N4C4S3S1", "env.obs_size=16", "ocr.cnn.hidden_size=16",
             "ocr.slotattr.num_slots=3", "ocr.slotattr.slot_size=32",
             "ocr.slotattr.mlp_hidden_size=32", "pooling.d_model=32",
             "pooling.nhead=4"]


def small_port_config():
    cfg = tcfg.PolicyConfig()
    for path, value in [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
                        ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
                        ("ocr.slotattr.mlp_hidden_size", 32),
                        ("pooling.d_model", 32), ("pooling.nhead", 4)]:
        cfg = tcfg.replace(cfg, path, value)
    return cfg


@pytest.mark.parametrize("jax_fused", ["never", "always"])
def test_get_slots_with_the_same_noise(jax_fused, monkeypatch):
    """SLATE's serving surface (CNN, positions, slot-attention encoder) with
    the JAX slot-init noise replaced by the test's numpy draws."""
    cfg = compose("train_sb3", SMALL_JAX + [f"ocr.slotattr.fused={jax_fused}"])
    jm = build_spec(cfg.ocr, cfg.env).module
    obs = np.random.default_rng(8).random((2, 16, 16, 3)).astype(np.float32)
    noise = rand(2, 3, 32, seed=9)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    rngs = {"noise": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(5)}
    p = jm.init(rngs, obs, method="get_slots")["params"]
    want_slots, want_attn = jm.apply({"params": p}, obs, method="get_slots", rngs=rngs)
    _, want_vis = jm.apply({"params": p}, obs, method="forward_with_attns", rngs=rngs)

    port = small_port_config()
    tm = load(SLATE_Module(port.ocr, port.env), p, ("ocr_module",), "ocr_module.")
    t_obs, t_noise = torch.from_numpy(obs), torch.from_numpy(noise)
    got_slots, got_attn = tm.get_slots(t_obs, noise=t_noise)
    close(got_slots, want_slots, STACK)
    close(got_attn, want_attn, STACK)
    close(tm(t_obs, noise=t_noise), want_slots, STACK)
    _, got_vis = tm.forward_with_attns(t_obs, noise=t_noise)
    close(got_vis, want_vis, STACK)


@pytest.mark.parametrize("pos_emb,stacked", [("None", 1), ("ape", 1), ("None", 2)])
def test_transformer_pooling(pos_emb, stacked):
    jcfg = compose("train_sb3", SMALL_JAX + [f"pooling.pos_emb={pos_emb}"]).pooling
    jm = jpooling("Transformer", 32, 3, jcfg, stacked)
    state = rand(2, 3 * stacked, 32, seed=10)
    p = jm.init(jax.random.PRNGKey(6), state)["params"]
    p = jax.tree.map(np.asarray, p)
    p["CoreTransformer_0"]["cls_token"] = rand(32, seed=11)   # not all-zero
    port = dataclasses.replace(small_port_config().pooling, pos_emb=pos_emb)
    tm = load(Transformer_Module(32, 3, port, stacked), p, ("pooling_module",),
              "pooling_module.")
    close(tm(torch.from_numpy(state)), jm.apply({"params": p}, state), STACK)


def test_pooling_refuses_later_options():
    """Every pooling option is ported, cw_embedding with the CausalWorld
    envs whose states it reads; what is still refused on the pooling path:
    a pooling that does not exist."""
    port = small_port_config().pooling
    Transformer_Module(32, 3, dataclasses.replace(port, use_mlp1=True))
    cfg = tcfg.compose(tcfg.TrainSB3Config(), ["pooling=transformer", "pooling.cw_embedding=True",
                                               "env=cw-target-N4C4S1S1"])
    assert cfg.pooling.cw_embedding and isinstance(cfg.env, tcfg.CwEnvConfig)
    with pytest.raises(ValueError, match="Unknown pooling"):
        create_pooling_module("Sum", 32, 3, port)


def test_actor_critic_heads():
    cfg = compose("train_sb3", SMALL_JAX)
    jm = JCustomNetwork(StaticConfig(cfg.sb3_acnet))
    feats = rand(4, 32, seed=12)
    p = jm.init(jax.random.PRNGKey(7), feats)["params"]
    tm = load(CustomNetwork(tcfg.ACNetConfig(), 32), p, ("acnet",), "acnet.")
    want_pi, want_vf = jm.apply({"params": p}, feats)
    got_pi, got_vf = tm(torch.from_numpy(feats))
    close(got_pi, want_pi, LAYER)
    close(got_vf, want_vf, LAYER)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_obs(dtype):
    from ocrl_tpu.models.base import normalize_obs as jnormalize
    from ocrl_tpu_torch.models.base import normalize_obs

    obs = np.random.default_rng(13).integers(0, 256, (2, 4, 4, 3)).astype(dtype)
    if dtype == np.float32:
        obs /= 255.0
    got = normalize_obs(torch.from_numpy(obs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnormalize(obs)))


def test_slate_call_with_cnn_features():
    """use_cnn_feat: the OCR returns CNN + position features with the image
    channels appended, one token per pixel."""
    cfg = compose("train_sb3", SMALL_JAX + ["ocr.use_cnn_feat=True"])
    jm = build_spec(cfg.ocr, cfg.env).module
    obs = np.random.default_rng(14).random((2, 16, 16, 3)).astype(np.float32)
    rngs = {"noise": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(6)}
    p = jm.init(rngs, obs, method="get_slots")["params"]
    port = tcfg.replace(small_port_config(), "ocr.use_cnn_feat", True)
    tm = load(SLATE_Module(port.ocr, port.env), p, ("ocr_module",), "ocr_module.")
    got = tm(torch.from_numpy(obs))
    assert tuple(got.shape) == (2, 256, 19)
    close(got, jm.apply({"params": p}, obs, rngs=rngs), STACK)


# -- training slice: dVAE, transformer decoder, SLATE loss --------------------

from ocrl_tpu.models import transformer as jtf
from ocrl_tpu.models.dvae import dVAE as JdVAE

from ocrl_tpu_torch.models import common as tcommon
from ocrl_tpu_torch.models import transformer as ttf
from ocrl_tpu_torch.models.dvae import dVAE

TINY = np.finfo(np.float32).tiny


class MaskFeed:
    """Dropout keep-masks made with numpy, one per call in call order, so
    that the JAX (jax.random.bernoulli) and the port (common.keep_mask)
    dropouts of the same module see the same masks."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def __call__(self, shape, keep_prob):
        self.shapes.append(tuple(shape))
        return self.rng.random(tuple(shape)) < keep_prob


def feed_masks(monkeypatch, seed):
    """Patch both frameworks' dropout masks with two identical feeds."""
    jfeed, tfeed = MaskFeed(seed), MaskFeed(seed)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(jfeed(shape, p)))
    monkeypatch.setattr(tcommon, "keep_mask",
                        lambda shape, keep, gen, dev: torch.from_numpy(tfeed(shape, keep)))
    return jfeed, tfeed


def test_pixel_shuffle():
    x = rand(2, 3, 4, 4 * 5)
    close(tcommon.pixel_shuffle(torch.from_numpy(x), 2),
          jcommon.pixel_shuffle(jnp.asarray(x), 2), dict(rtol=0, atol=0))


@pytest.mark.parametrize("step", [0, 1, 7, 14999, 29999, 30000, 250000])
def test_schedules(step):
    """The tau anneal and the lr warm-up as plain functions of the step; the
    JAX ones compute in fp32, so 1e-6 relative."""
    for fn in ("cosine_anneal", "linear_warmup"):
        got = getattr(tcommon, fn)(step, 1.0, 0.1, 0, 30000)
        want = float(getattr(jcommon, fn)(step, 1.0, 0.1, 0, 30000))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_straight_through(hard, monkeypatch):
    """Values and gradients of the (hard: straight-through) Gumbel-softmax,
    with the same exponential draws."""
    logits, w = rand(6, 16, seed=20), rand(6, 16, seed=21)
    e = np.random.default_rng(22).exponential(size=(6, 16)).astype(np.float32)
    monkeypatch.setattr(jax.random, "exponential",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(e))

    def jf(x):
        y = jcommon.gumbel_softmax(jax.random.PRNGKey(0), x, 0.5, hard)
        return jnp.sum(y * w), y

    (_, want_y), want_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    y = tcommon.gumbel_softmax(x, torch.from_numpy(-np.log(e + TINY)), 0.5, hard)
    (y * torch.from_numpy(w)).sum().backward()
    close(y, want_y, LAYER)
    close(x.grad, want_g, LAYER)


def _dvae_params(obs, V=32):
    jm = JdVAE(V, 3)
    p = jm.init({"params": jax.random.PRNGKey(8), "noise": jax.random.PRNGKey(9)},
                obs, 1.0, False)["params"]
    p = jax.tree.map(np.asarray, p)
    # decoder params are created by decode; init them too
    z = np.random.default_rng(10).random((obs.shape[0], obs.shape[1] // 4,
                                          obs.shape[2] // 4, V)).astype(np.float32)
    pd = jm.init({"params": jax.random.PRNGKey(8)}, z, method="decode")["params"]
    p.update({k: v for k, v in jax.tree.map(np.asarray, pd).items() if k not in p})
    return jm, p, z


def test_dvae_encode_and_decode():
    """dVAE encoder logits (4x4 stride-4 conv, six 1x1 blocks, 1x1 to the
    vocabulary) and decoder (nine blocks, two pixel shuffles): conv stacks,
    1e-4 relative."""
    obs = np.random.default_rng(11).random((2, 16, 16, 3)).astype(np.float32)
    jm, p, z = _dvae_params(obs)
    tm = load(dVAE(32, 3), p, ("ocr_module", "dvae"), "ocr_module.dvae.")
    close(tm.encode_logits(torch.from_numpy(obs)),
          jm.apply({"params": p}, obs, method="encode_logits"), STACK)
    recon = tm.decode(torch.from_numpy(z))
    assert tuple(recon.shape) == (2, 16, 16, 3)
    close(recon, jm.apply({"params": p}, z, method="decode"), STACK)


def test_dvae_soft_sample(monkeypatch):
    """dVAE.__call__ with hard=False: the B1 path (plain version here) with
    the JAX exponential draws given as the field."""
    obs = np.random.default_rng(12).random((2, 16, 16, 3)).astype(np.float32)
    jm, p, _ = _dvae_params(obs)
    e = np.random.default_rng(13).exponential(size=(32, 32)).astype(np.float32)
    monkeypatch.setattr(jax.random, "exponential",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(e))
    want_z, want_logits = jm.apply({"params": p}, obs, 0.7, False,
                                   rngs={"noise": jax.random.PRNGKey(0)})
    tm = load(dVAE(32, 3), p, ("ocr_module", "dvae"), "ocr_module.dvae.")
    z, logits = tm(torch.from_numpy(obs), 0.7, False,
                   noise=torch.from_numpy(-np.log(e + TINY)))
    close(logits, want_logits, STACK)
    close(z, want_z, STACK)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(train, masked, monkeypatch):
    """Head split, hd ** -0.5, the causal mask as -inf, and dropout on the
    attention weights and on the output with the same keep-masks."""
    q, kv = rand(2, 5, 16, seed=30), rand(2, 3 if not masked else 5, 16, seed=31)
    mask = np.triu(np.ones((5, 5), bool), 1) if masked else None
    jfeed, tfeed = feed_masks(monkeypatch, 32)
    jm = jtf.MultiHeadAttention(16, 4, dropout=0.25, gain=0.5)
    p = jm.init(jax.random.PRNGKey(33), q, kv, kv)["params"]
    want = jm.apply({"params": p}, q, kv, kv, mask, deterministic=not train,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    tm = load(ttf.MultiHeadAttention(16, 4, 0.25, 0.5), p,
              ("ocr_module", "tfdec", "blocks_0", "self_attn"),
              "ocr_module.tfdec.blocks.0.self_attn.")
    got = tm(*map(torch.from_numpy, (q, kv, kv)),
             None if mask is None else torch.from_numpy(mask), train=train)
    close(got, want, LAYER)
    assert jfeed.shapes == tfeed.shapes == ([(2, 4, 5, kv.shape[1]), (2, 5, 16)]
                                            if train else [])


def test_ffn_with_dropout(monkeypatch):
    x = rand(2, 5, 16, seed=34)
    feed_masks(monkeypatch, 35)
    jm = jtf.FFN(16, 0.5, 0.25)
    p = jm.init(jax.random.PRNGKey(36), x)["params"]
    want = jm.apply({"params": p}, x, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    tm = load(ttf.FFN(16, 0.5, 0.25), p, ("ocr_module", "tfdec", "blocks_0", "ffn"),
              "ocr_module.tfdec.blocks.0.ffn.")
    close(tm(torch.from_numpy(x), train=True), want, LAYER)


@pytest.mark.parametrize("is_first", [True, False])
def test_transformer_decoder_block(is_first, monkeypatch):
    x, enc = rand(2, 6, 16, seed=37), rand(2, 3, 16, seed=38)
    feed_masks(monkeypatch, 39)
    jm = jtf.TransformerDecoderBlock(16, 2, 0.1, 0.5, is_first)
    p = jm.init(jax.random.PRNGKey(40), x, enc)["params"]
    want = jm.apply({"params": p}, x, enc, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    tm = load(ttf.TransformerDecoderBlock(16, 2, 0.1, 0.5, is_first), p,
              ("ocr_module", "tfdec", "blocks_0"), "ocr_module.tfdec.blocks.0.")
    close(tm(torch.from_numpy(x), torch.from_numpy(enc), train=True), want, STACK)


def test_transformer_decoder_and_positions(monkeypatch):
    """Three blocks with gain (3 * 3) ** -0.5 and the final LayerNorm, fed
    by the learned positional encoding, all with dropout."""
    x, enc = rand(2, 7, 16, seed=41), rand(2, 3, 16, seed=42)
    feed_masks(monkeypatch, 43)
    jpos = jtf.LearnedPositionalEncoding(8, 16, 0.1)
    ppos = jpos.init(jax.random.PRNGKey(44), x)["params"]
    jdec = jtf.TransformerDecoder(3, 7, 16, 4, 0.1)
    pdec = jdec.init(jax.random.PRNGKey(45), x, enc)["params"]
    rngs = {"dropout": jax.random.PRNGKey(0)}
    want = jdec.apply({"params": pdec},
                      jpos.apply({"params": ppos}, x, deterministic=False, rngs=rngs),
                      enc, deterministic=False, rngs=rngs)
    tpos = load(ttf.LearnedPositionalEncoding(8, 16, 0.1), ppos,
                ("ocr_module", "z_pos"), "ocr_module.z_pos.")
    tdec = load(ttf.TransformerDecoder(3, 7, 16, 4, 0.1), pdec,
                ("ocr_module", "tfdec"), "ocr_module.tfdec.")
    got = tdec(tpos(torch.from_numpy(x), train=True), torch.from_numpy(enc), train=True)
    close(got, want, STACK)


SMALL_TRAIN = [("ocr.dvae.vocab_size", 32), ("ocr.dvae.d_model", 32),
               ("ocr.tfdec.num_dec_blocks", 2), ("ocr.tfdec.num_dec_heads", 2)]


def small_train_modules(extra=()):
    """The JAX SLATE module (Pallas sweep in interpret mode) and its params,
    and the port's module carrying them, at the small width."""
    over = SMALL_TRAIN + list(extra)
    cfg = compose("train_sb3", SMALL_JAX + ["ocr.slotattr.fused=auto"]
                  + [f"{k}={v}" for k, v in over])
    jm = build_spec(cfg.ocr, cfg.env).module
    obs = np.zeros((1, 16, 16, 3), np.float32)
    p = jm.init({"params": jax.random.PRNGKey(46), "noise": jax.random.PRNGKey(1),
                 "noise2": jax.random.PRNGKey(2)}, obs, method="init_all")["params"]
    p = jax.tree.map(np.asarray, p)
    port = small_port_config()
    for k, v in over:
        port = tcfg.replace(port, k, v)
    tm = load(SLATE_Module(port.ocr, port.env, decoder=True), p, ("ocr_module",),
              "ocr_module.")
    return jm, p, tm


def _slate_noise(B, monkeypatch, seed):
    """The JAX draws in call order (soft field, ids field: exponentials;
    slot noise: normal) and the same fields for the port."""
    rng = np.random.default_rng(seed)
    e = [rng.exponential(size=(B * 16, 32)).astype(np.float32) for _ in range(2)]
    slots = rng.standard_normal((B, 3, 32)).astype(np.float32)
    calls = []

    def exponential(key, shape, dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(e[len(calls) - 1])

    monkeypatch.setattr(jax.random, "exponential", exponential)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(slots))
    return {"soft": torch.from_numpy(-np.log(e[0] + TINY)),
            "ids": torch.from_numpy(-np.log(e[1] + TINY)),
            "slots": torch.from_numpy(slots)}


def test_teacher_forced_cross_entropy(monkeypatch):
    jm, p, tm = small_train_modules()
    rng = np.random.default_rng(47)
    slots = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ids = rng.integers(0, 32, (2, 16))
    want = jm.apply({"params": p}, slots, ids, False, method="_teacher_forced_ce")
    got = tm._teacher_forced_ce(torch.from_numpy(slots), torch.from_numpy(ids), False)
    close(got, want, STACK)


@pytest.mark.parametrize("step", [0, 12345, 40000])
def test_slate_loss_and_metrics(step, monkeypatch):
    """SLATE's loss (dVAE MSE + teacher-forced CE) and every metric, in
    training mode with dropout 0, on the same draws."""
    jm, p, tm = small_train_modules([("ocr.learning.dropout", 0.0)])
    obs = np.random.default_rng(48).random((2, 16, 16, 3)).astype(np.float32)
    noise = _slate_noise(2, monkeypatch, 49)
    _, want = jm.apply({"params": p}, obs, None, step, True, method="loss",
                       rngs={k: jax.random.PRNGKey(i) for i, k in
                             enumerate(("noise", "noise2", "dropout"))})
    _, got = tm.loss(torch.from_numpy(obs), None, step, True, noise=noise)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key].detach() if torch.is_tensor(got[key])
                                              else got[key]), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


def test_slate_training_surface_refuses_later_slices():
    """What is still refused: the loss of a module built without its decoder
    (a policy's). The other OCRs' pretraining step (here IODINE's) runs
    since the slice that ports it, held against JAX in
    test_torch_pretrain.py. Masks, generation and use_bcdec, refused before
    the evaluation slice, are held against JAX in test_torch_eval.py; the
    other OCRs' serving and RL paths in test_torch_ocrs.py."""
    from ocrl_tpu_torch.models import create_ocr

    port = small_port_config()
    obs = torch.zeros(1, 16, 16, 3)
    with pytest.raises(RuntimeError, match="without its decoder"):
        SLATE_Module(port.ocr, port.env).loss(obs, torch.zeros(1, 4, 16, 16, 1))
    iodine = tcfg.IodineConfig(slot_size=8, num_iterations=2)
    metrics = create_ocr(iodine, port.env, device="cpu").update(obs, None, 0)
    assert {"loss", "mse", "kld", "norm"} == set(metrics)
    assert all(torch.isfinite(v) for v in metrics.values())
    _, _, tm = small_train_modules([("ocr.use_bcdec", True)])
    assert tm.use_bcdec and hasattr(tm, "bcdec") and hasattr(tm, "tfdec")
