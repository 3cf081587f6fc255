"""Slot attention at every head count, slot count and slot width that JAX
runs: the port against the JAX package on the CPU, with numpy inputs from a
seed (the kernels themselves are held against the plain version on the
card: tests/test_torch_cuda.py, chip_smoke.py).

(i) the sweep at one head with S in {17, 24, 32} and D in {21, 40, 100}
    against JAX's ``route_sweep`` in interpret mode, its outputs and its
    custom VJP;
(ii) ``SlotAttention`` with 2, 3 and 4 heads (a head width of 7 included)
    against JAX's einsum route, and with 20 slots at odd widths against
    JAX's ``fused=always`` (the Pallas sweep in interpret mode): slots,
    attention and every parameter's gradient of a loss of the slots;
(iii) one SLATE ``OCR.update`` with ``num_slot_heads=2`` and one with
    ``num_slots=20`` at small width against JAX's step, from the same
    weights and draws;
(iv) the port's ``fused=always`` raising exactly where JAX's raises, and a
    JAX tree with heads carried by ``utils/convert.py`` as it stands.
Besides: the plain sweep with heads against a float64 loop over the
definition, ``torch.func.vmap`` of it, what ``auto`` and ``never`` do past
the kernels' range, and the C source's constants that ``ops.slot_routing``
mirrors.

Tolerance STACK (rtol 1e-4, atol 1e-5, as tests/test_torch_models.py): the
two frameworks sum the dot products and the token sums in other orders, and
the three-iteration recurrence carries that on; the update follows
tests/test_torch_train.py's rules (metrics 1e-5 relative, each gradient to
1e-4 of its leaf's largest entry plus 1e-7 of the model's, parameters as
their change over the lr to 1e-2).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optax

from ocrl_tpu.config import compose
from ocrl_tpu.models import build_spec
from ocrl_tpu.models.base import clip_by_total_norm, global_norm
from ocrl_tpu.models.slot_attention import SlotAttention as JSlotAttention
from ocrl_tpu.ops import slot_routing as jsr

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models.slate import GROUP_OF
from ocrl_tpu_torch.models.slot_attention import SlotAttention
from ocrl_tpu_torch.ops import slot_routing as tsr
from ocrl_tpu_torch.utils.convert import attention_heads, from_flax, ocr_from_flax, ocr_to_flax

STACK = dict(rtol=1e-4, atol=1e-5)
PREFIX = ("ocr_module", "slotattn", "slot_attention")
PORT_PREFIX = "ocr_module.slotattn.slot_attention."
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, tol=STACK, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=msg, **tol)


def port_state(tree):
    """A flax SlotAttention tree -> the port module's state_dict."""
    tree = jax.tree.map(np.asarray, tree)
    for key in reversed(PREFIX):
        tree = {key: tree}
    return {k[len(PORT_PREFIX):]: v for k, v in from_flax(tree).items()}


# -- (i) the op at one head, past the single-head kernels' range -------------

@pytest.mark.parametrize("D", [21, 40, 100])
@pytest.mark.parametrize("S", [17, 24, 32])
def test_sweep_at_one_head_matches_jax(S, D):
    """Outputs and the VJP of all three (JAX's custom VJP runs its Pallas
    backward kernel in interpret mode over 4 chunks)."""
    B, N = 2, 64
    rng = np.random.default_rng(S * 1000 + D)
    k = (rng.standard_normal((B, N, D)) * D ** -0.5).astype(np.float32)
    v, q = (rng.standard_normal(s).astype(np.float32) for s in ((B, N, D), (B, S, D)))
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((B, S), (B, S, D), (B, N, S))]

    @jax.jit
    def jax_side(k, v, q, cots):
        want, vjp = jax.vjp(lambda *x: jsr.route_sweep(jsr.pick_chunk(N, target=16), *x), k, v, q)
        return want, vjp(cots)

    want, want_grads = jax_side(k, v, q, tuple(cots))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (k, v, q)]
    got = tsr.route_sweep(*leaves)
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(c) for c in cots])
    for name, g, w in zip(("S_a", "A_v", "a", "gk", "gv", "gq"), (*got, *grads),
                          (*want, *want_grads)):
        assert tuple(g.shape) == w.shape, name
        close(g, w, msg=name)


def test_plain_sweep_with_heads_follows_the_definition():
    """route_sweep_reference with heads against a float64 loop over the
    definition: a[n, h S + s] = softmax over (h, s) of the dot product over
    head h's columns, S_a = sum_n a, A_v[s, c] = sum_n a[n, h(c) S + s] v[n, c]."""
    B, N, S, H, D = 2, 9, 3, 3, 21
    hd = D // H
    k, v, q = rand(B, N, D, seed=1), rand(B, N, D, seed=2), rand(B, S, D, seed=3)
    a = np.zeros((B, N, H * S))
    for b in range(B):
        for n in range(N):
            logits = np.array([k[b, n, h * hd:(h + 1) * hd].astype(np.float64)
                               @ q[b, s, h * hd:(h + 1) * hd] for h in range(H) for s in range(S)])
            e = np.exp(logits - logits.max())
            a[b, n] = e / e.sum()
    av = np.zeros((B, S, D))
    for c in range(D):
        av[:, :, c] = np.einsum("bns,bn->bs", a[:, :, (c // hd) * S:(c // hd + 1) * S],
                                v[:, :, c].astype(np.float64))
    got = tsr.route_sweep(*map(torch.from_numpy, (k, v, q)), H)
    for g, w in zip(got, (a.sum(1), av, a)):
        close(g, w, dict(rtol=1e-5, atol=1e-6))


def test_vmap_of_the_sweep_with_heads():
    """torch.func.vmap over seeds of route_sweep with heads (the multi-seed
    policy call's form) equals the seeds one by one, outputs and gradients."""
    from torch.func import vjp, vmap

    V, B, N, S, H, D = 3, 2, 10, 5, 4, 32
    k, v = (torch.from_numpy(rand(V, B, N, D, seed=s)) for s in (4, 5))
    q = torch.from_numpy(rand(V, B, S, D, seed=6))
    cots = [torch.from_numpy(rand(*s, seed=7)) for s in ((V, B, H * S), (V, B, S, D),
                                                        (V, B, N, H * S))]
    outs = vmap(lambda k, v, q: tsr.route_sweep(k, v, q, H))(k, v, q)
    grads = vmap(lambda k, v, q, *c: vjp(lambda *x: tsr.route_sweep(*x, H), k, v, q)[1](c))(
        k, v, q, *cots)
    for i in range(V):
        leaves = [x[i].clone().requires_grad_() for x in (k, v, q)]
        want = tsr.route_sweep(*leaves, H)
        want_grads = torch.autograd.grad(want, leaves, [c[i] for c in cots])
        for g, w in zip((*outs, *grads), (*want, *want_grads)):
            torch.testing.assert_close(g[i], w, rtol=1e-6, atol=1e-6)


def test_vmap_rules_pass_the_heads_through(monkeypatch):
    """The two Functions' vmap rules with heads (the card's path, with the
    launches replaced by plain versions that see the folded [V*B, ...]
    tensors): one forward at V * B rows under vmap, one forward and one
    backward under vmap(grad), the head count passed on unbatched, and
    the plain sweep's values."""
    from torch.func import grad, vmap

    launches = []

    def fwd(k, v, q, heads=1):
        launches.append(("fwd", k.shape[0], heads))
        with torch.no_grad():
            return tsr.route_sweep_reference(k, v, q, heads)

    def bwd(k, v, q, a, g_av, g_a, heads=1):
        launches.append(("bwd", k.shape[0], heads))
        leaves = [x.detach().requires_grad_() for x in (k, v, q)]
        with torch.enable_grad():
            _, av, a2 = tsr.route_sweep_reference(*leaves, heads)
            return torch.autograd.grad((av, a2), leaves, (g_av, g_a))

    monkeypatch.setattr(tsr, "_sweep_fwd", fwd)
    monkeypatch.setattr(tsr, "_sweep_bwd", bwd)
    V, B, N, S, H, D = 3, 2, 10, 5, 4, 32
    k, v = (torch.from_numpy(rand(V, B, N, D, seed=s)) for s in (8, 9))
    q = torch.from_numpy(rand(V, B, S, D, seed=10))

    def loss(sweep):
        return lambda k, v, q: sum(x.square().sum() for x in sweep(k, v, q, H))

    outs = vmap(tsr._RouteSweep.apply, in_dims=(0, 0, 0, None))(k, v, q, H)
    assert launches == [("fwd", V * B, H)]
    launches.clear()
    grads = vmap(grad(loss(tsr._RouteSweep.apply), argnums=(0, 1, 2)))(k, v, q)
    assert launches == [("fwd", V * B, H), ("bwd", V * B, H)]
    want = vmap(lambda k, v, q: tsr.route_sweep_reference(k, v, q, H))(k, v, q)
    want_grads = vmap(grad(loss(tsr.route_sweep_reference), argnums=(0, 1, 2)))(k, v, q)
    for g, w in zip((*outs, *grads), (*want, *want_grads)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# -- (ii) SlotAttention against JAX ------------------------------------------

_JAX_SIDES = {}


def _slot_attention_pair(S, D, H, jax_fused, port_fused, N=64, D_in=16):
    """JAX's module, params, slots, attention and the gradients of
    sum(w * slots) (one jitted call, kept for the other port route), and
    the port's module on the same weights."""
    inputs, slots0 = rand(2, N, D_in, seed=S + D), rand(2, S, D, seed=S + D + 1)
    key = (S, D, H, jax_fused)
    if key not in _JAX_SIDES:
        jm = JSlotAttention(3, S, D_in, D, D, H, fused=jax_fused)
        params = jax.jit(jm.init)(jax.random.PRNGKey(S + D + H), inputs, slots0)["params"]

        @jax.jit
        def jax_side(p):
            (slots, attn), vjp = jax.vjp(lambda p: jm.apply({"params": p}, inputs, slots0), p)
            return slots, attn, vjp((jnp.asarray(WEIGHT(slots0.shape)), jnp.zeros_like(attn)))[0]

        _JAX_SIDES[key] = (params, jax_side(params))
    params, want = _JAX_SIDES[key]
    tm = SlotAttention(3, S, D_in, D, D, H, fused=port_fused)
    tm.load_state_dict(port_state(params))
    return want, tm, inputs, slots0


def WEIGHT(shape):
    return rand(*shape, seed=99)


def _check_forward_and_gradients(want, tm, inputs, slots0):
    """Slots and attention, then every parameter's gradient of
    sum(w * slots) for a fixed w."""
    want_slots, want_attn, want_grads = want
    want_grads = port_state(want_grads)
    got_slots, got_attn = tm(torch.from_numpy(inputs), torch.from_numpy(slots0))
    close(got_slots, want_slots, msg="slots")
    close(got_attn, want_attn, msg="attention")
    (got_slots * torch.from_numpy(WEIGHT(slots0.shape))).sum().backward()
    top = max(np.abs(w.numpy()).max() for w in want_grads.values())
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= STACK["rtol"] * np.abs(w).max() + STACK["atol"] * top, (name, err)


@pytest.mark.parametrize("port_fused", ["auto", "never"])
@pytest.mark.parametrize("H,D", [(2, 32), (3, 21), (4, 48)])
def test_slot_attention_with_heads_matches_jax(H, D, port_fused):
    """JAX takes its einsum route for more than one head (``auto`` too);
    the port's auto takes the sweep (its plain version here), ``never`` the
    einsum route. D = 21 in 3 heads: a head width of 7."""
    _check_forward_and_gradients(*_slot_attention_pair(5, D, H, "auto", port_fused))


@pytest.mark.parametrize("D", [21, 45])
def test_twenty_slots_match_jax_always(D):
    """20 slots at an odd width: JAX's fused=always (the Pallas sweep in
    interpret mode, N = 64 in chunks) against the port's auto."""
    _check_forward_and_gradients(*_slot_attention_pair(20, D, 1, "always", "auto"))


# -- (iv) where fused=always raises, and the routes past the kernels' range ----

@pytest.mark.parametrize("H,N", [(1, 64), (1, 24), (1, 12), (1, 4), (1, 50), (2, 64),
                                 (4, 50)])
def test_always_raises_exactly_where_jax_does(H, N):
    """JAX's fused=always raises, while it traces, for more than one head or
    for an N that no power-of-two chunk from 8 to 512 divides (it skips the
    check while initialising); the port's raises in the same cases, and runs
    the others through the sweep."""
    inputs, slots0 = rand(1, N, 16, seed=N), rand(1, 3, 32, seed=H)
    jm = JSlotAttention(1, 3, 16, 32, 32, H, fused="always")
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), inputs, slots0)["params"]
    try:
        jax.eval_shape(lambda p: jm.apply({"params": p}, inputs, slots0), params)
        jax_raises = False
    except ValueError as e:
        jax_raises = "ineligible" in str(e)
    assert jax_raises == (H != 1 or tsr.pick_chunk(N) == 0)
    tm = SlotAttention(1, 3, 16, 32, 32, H, fused="always")
    if jax_raises:
        with pytest.raises(ValueError, match="ineligible"):
            tm(torch.from_numpy(inputs), torch.from_numpy(slots0))
    else:
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsr, "route_sweep", lambda *a: calls.append(a) or tsr.route_sweep_reference(*a))
            out, _ = tm(torch.from_numpy(inputs), torch.from_numpy(slots0))
        assert out.shape == (1, 3, 32) and len(calls) == 1


def test_a_jax_tree_with_heads_converts():
    """utils/convert.py carries a tree that JAX made with heads as it
    stands: SlotAttentionEncoder's leaves with 4 heads are the port
    module's, name for name and shape for shape, the same as with one head
    (heads add no parameter), and load strictly; a SLATE module with heads
    goes to JAX's tree and back bitwise."""
    from ocrl_tpu.models.slot_attention import SlotAttentionEncoder as JEncoder

    from ocrl_tpu_torch.models.slot_attention import SlotAttentionEncoder

    x = rand(2, 16, 8)
    tree = jax.jit(JEncoder(3, 5, 8, 32, 32, 4).init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, x)["params"]
    state = {k[len("ocr_module.slotattn."):]: v for k, v in
             from_flax({"ocr_module": {"slotattn": jax.tree.map(np.asarray, tree)}}).items()}
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    for heads in (4, 1):
        port = SlotAttentionEncoder(3, 5, 8, 32, 32, heads)
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == shapes
    port.load_state_dict(state)
    ocr_cfg, env_cfg = port_configs(SMALL + VARIANTS["heads2"])
    module = create_ocr(ocr_cfg, env_cfg, seed=1, device="cpu").module
    back = ocr_from_flax(ocr_to_flax(module.state_dict(), attention_heads(module)))
    for key, value in module.state_dict().items():
        assert torch.equal(back[key], value), key


def test_past_the_kernels_range():
    """Past the kernels' range (33 slots): auto takes the einsum route on the
    CPU, never does anywhere, always raises NotImplementedError naming the
    shape (and auto does too on a CUDA tensor: no silent second route)."""
    x, s = torch.from_numpy(rand(1, 16, 8)), torch.from_numpy(rand(1, 33, 32))
    for fused in ("auto", "never"):
        out, attn = SlotAttention(1, 33, 8, 32, 32, 1, fused=fused)(x, s)
        assert out.shape == (1, 33, 32) and attn.shape == (1, 16, 33)
    with pytest.raises(NotImplementedError, match="slots=33"):
        SlotAttention(1, 33, 8, 32, 32, 1, fused="always")(x, s)
    assert SlotAttention(1, 33, 8, 32, 32, 1)._use_sweep(torch.device("cpu"), 16) is False
    with pytest.raises(NotImplementedError, match="slots=33"):
        SlotAttention(1, 33, 8, 32, 32, 1)._use_sweep(torch.device("cuda"), 16)
    assert SlotAttention(1, 32, 8, 512, 32, 8)._use_sweep(torch.device("cuda"), 16)
    assert not SlotAttention(1, 32, 8, 512, 32, 8, fused="never")._use_sweep(
        torch.device("cuda"), 16)


def test_source_constants_match_the_wrapper():
    """ops.slot_routing mirrors the C entries' rules: the tiles, stage
    counts, slot blocks, lanes, token groups and limits of
    csrc/slot_routing.cu's heads kernels and their plan."""
    text = (Path(tsr.__file__).parent / "csrc" / "slot_routing.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name}(\[\])? = ([^;]+);", text).group(2)

    assert const("kHeadsTiles") == "{" + ", ".join(map(str, tsr.HEADS_TILES)) + "}"
    assert int(const("kHeadsFwdStages")) == tsr.HEADS_FWD_STAGES
    assert const("kHeadsBwdStages") == "{" + ", ".join(map(str, tsr.HEADS_BWD_STAGES)) + "}"
    assert int(const("kHeadsMaxSlots")) == tsr.MAX_SLOTS
    assert int(const("kSlotBlock")) == tsr.SLOT_BLOCK
    assert int(const("kNarrowLanes")) == tsr.NARROW_LANES
    assert int(const("kWideLanes")) == tsr.WIDE_LANES
    assert int(const("kNarrowHead")) == tsr.NARROW_HEAD
    assert int(const("kMaxGroups")) == tsr.MAX_GROUPS
    assert int(const("kConsumers")) == tsr.CONSUMERS
    assert const("kFwdTiles") == "{64, 48, 32, 24, 16, 8}"
    assert int(const("kHeaderBytes")) == 128


# -- (iii) one SLATE update with heads, and with 20 slots ----------------------

SMALL = [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
         ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
         ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
         ("ocr.dvae.d_model", 32), ("ocr.tfdec.num_dec_blocks", 1),
         ("ocr.tfdec.num_dec_heads", 2), ("ocr.learning.dropout", 0.0)]
VARIANTS = {"heads2": [("ocr.slotattr.num_slot_heads", 2)],
            "slots20": [("ocr.slotattr.num_slots", 20)]}
B = 2


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_step(request):
    """(overrides, draws, the port's initial weights as JAX's tree, JAX's
    loss metrics and gradients, JAX's metrics and params after its update)
    with JAX's random draws patched to the test's numpy draws. The JAX side
    is JAX's own SLATE module and optimizer (``build_spec``, and the clip
    chained before it as ``ocrl_tpu.models.base.OCR`` does), started from
    the port's random weights (so no JAX init is compiled); its update is
    ``OCR.train_step``'s: metrics, the norm, then ``tx.update``."""
    over = SMALL + VARIANTS[request.param]
    S = dict(over)["ocr.slotattr.num_slots"]
    rng = np.random.default_rng(len(request.param))
    obs = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    e = [rng.exponential(size=(B * 16, 32)).astype(np.float32) for _ in range(2)]
    slots = rng.standard_normal((B, S, 32)).astype(np.float32)
    calls = []

    def exponential(key, shape, dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(e[(len(calls) - 1) % 2])   # soft field, then ids field

    cfg = compose("train_sb3", ["ocr=slate", "env=target-N4C4S3S1", "pooling=transformer",
                                "sb3=ppo", "sb3_acnet=mlp", "ocr.slotattr.fused=auto"]
                  + [f"{k}={v}" for k, v in over])
    spec = build_spec(cfg.ocr, cfg.env)
    ocr_cfg, env_cfg = port_configs(over)
    port = create_ocr(ocr_cfg, env_cfg, seed=1, device="cpu").module
    params0 = ocr_to_flax(port.state_dict(), attention_heads(port))
    tx = optax.chain(clip_by_total_norm(spec.clip, spec.clip_ord), spec.optimizer)

    @jax.jit
    def train_step(params, obs):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: spec.module.apply(
                {"params": p}, obs, None, 0, True, method="loss",
                rngs={s: jax.random.PRNGKey(i) for i, s in enumerate(spec.rng_streams)}),
            has_aux=True)(params)
        metrics = dict(metrics, norm=global_norm(grads, spec.clip_ord))
        updates, _ = tx.update(grads, tx.init(params), params)
        return metrics, grads, optax.apply_updates(params, updates)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "exponential", exponential)
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(slots))
        with jax.default_matmul_precision("highest"):
            metrics, grads, after = jax.device_get(
                train_step(params0, obs.astype(np.float32) / 255.0))
    metrics = {k: float(v) for k, v in metrics.items()}
    yield over, (obs, e, slots), params0, grads, metrics, jax.tree.map(np.asarray, after)


def port_configs(over):
    cfg = tcfg.PolicyConfig()
    for path, value in over:
        cfg = tcfg.replace(cfg, path, value)
    return cfg.ocr, cfg.env


def test_update_matches_jax(jax_step):
    """One update from step 0: every metric, the clipped gradients and the
    parameters after it (tests/test_torch_train.py's rules). A parameter's
    change over the lr is Adam's first step g / (|g| + eps) on each side, so
    entries whose gradient is within a few eps of 0 on JAX's side turn the
    gradients' rounding into any change in [-1, 1] (one entry of the CNN
    encoder with 2 heads: 1.118 against 1.083 at |g| about 3e-7); those,
    |g| < 1e-6, are held to Adam's whole step (1, and the float32 rounding
    of the parameter it lands on at step 0's warm-up lr) on both sides, and
    all others to 1e-2, as chip_smoke.check_step holds the card's step."""
    over, (obs, e, slots), params0, jgrads, want, after = jax_step
    ocr_cfg, env_cfg = port_configs(over)
    ocr = create_ocr(ocr_cfg, env_cfg, seed=1, device="cpu")
    ocr.module.load_state_dict(ocr_from_flax(params0))
    noise = {"soft": torch.from_numpy(-np.log(e[0] + TINY)),
             "ids": torch.from_numpy(-np.log(e[1] + TINY)), "slots": torch.from_numpy(slots)}
    got = ocr.update(obs, None, 0, noise=noise)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=key)

    scale = min(1.0, ocr_cfg.learning.clip / (want["norm"] + 1e-6))
    want_grads = {k: v * scale for k, v in
                  ocr_from_flax(jax.tree.map(np.asarray, jgrads)).items()}
    grads = {k: p.grad for k, p in ocr.module.named_parameters()}
    assert set(grads) == set(want_grads)
    top = max(w.abs().max().item() for w in want_grads.values())
    for key, w in want_grads.items():
        err = (grads[key] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-7 * top, (key, err)

    start, after = ocr_from_flax(params0), ocr_from_flax(after)
    lr = {g["group"]: g["lr"] for g in ocr.optimizer.adam.param_groups}   # step 0's
    for key, p in ocr.module.state_dict().items():
        group_lr = lr[GROUP_OF[key.split(".")[0]]]
        moved = ((p - start[key]) / group_lr).numpy()
        want_moved = ((after[key] - start[key]) / group_lr).numpy()
        near_zero = want_grads[key].abs().numpy() < 1e-6
        # Adam's whole step, and the rounding of the parameter it lands on
        step = 1 + 1e-5 + np.spacing(np.abs(start[key].numpy()) + 2 * group_lr) / group_lr
        assert (np.abs(moved) <= step)[near_zero].all(), key
        assert (np.abs(want_moved) <= step)[near_zero].all(), key
        np.testing.assert_allclose(moved[~near_zero], want_moved[~near_zero], atol=1e-2,
                                   err_msg=key)
