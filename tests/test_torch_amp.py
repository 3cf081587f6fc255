"""``ocr.amp=bf16`` in the port against the JAX package's, on the CPU.

The conv stacks of SLATE and Slot-Attention (the dVAE's encoder and decoder,
the CNN encoder, the broadcast decoder) compute in bf16 with fp32
parameters, optimizer state, loss and files (ocrl_tpu/models/slate.py:51-57).
Both sides run at JAX's ``TINY`` widths (tests/test_slate.py:9-15) at obs 16,
and at obs 64 where the broadcast decoder's tile gather sums (64 - 4)^2
cotangents into one entry. Inputs and draws come from numpy at a seed; the
weights are the port's, carried to JAX by ``utils.convert.ocr_to_flax``, so
that no JAX initialisation is compiled. JAX runs under
``jax.default_matmul_precision("highest")``.

The fp32 reference ``r`` below is the port's fp32 run (``amp`` off) of the
same weights and draws: tests/test_torch_train.py holds it to JAX's fp32
step within 1e-5 of each metric and 1e-4 of each gradient's largest entry,
far inside bf16's 2^-8.

Rules, and why:
- A stage fed the same input: the port's output holds bf16 values only (amp
  is applied); max |port - JAX| within STAGE_ULPS bf16 ulps of the stage's
  output scale (ulp(x) = 2^(floor(log2 x) - 7)); at most STAGE_SHARE of the
  bf16 outputs differ. Both sides sum each convolution in fp32, round it to
  bf16, then add the bias in bf16, a second rounding (XLA's HLO of flax's
  ``nn.Conv(dtype=bfloat16)``, which ``common.conv_nhwc`` writes out): only
  the order of the fp32 sums differs, so an output moves by one ulp where
  its exact sum lies near a rounding boundary, and the layers after it carry
  that on. Measured over five seeds: at most 1.25 ulps; at most 6.3 % of the
  outputs differ (the dVAE's decoder, ten layers deep), none at all in
  about half the cases at obs 16. The
  broadcast decoder's composite is fp32 arithmetic on those bf16 values: its
  max is held to STAGE_ULPS of its scale, its share on its last bf16 block.
- One update of the whole model, loss metrics: |port - JAX| within SAME_PATH
  of JAX's own distance from ``r`` plus 1e-5 of max(|r|, 1) (the fp32
  rule): the two bf16 runs agree 20 times closer than either lies to fp32
  (measured 0.005 of it and less), so a port that stayed fp32 fails here.
- Its gradients, per leaf, unclipped, and their inf-norm (``norm``): the
  port no farther from ``r`` than GRAD_C times JAX's distance, plus half a
  bf16 ulp of the leaf's largest entry (a bf16 gradient is rounded once
  more) and 1e-7 of the model's largest. JAX on the CPU sums the bias
  gradients of its bf16 convolutions in bf16: the VJP of flax's broadcast
  bias add reduces in bf16, which stalls once the running sum outgrows its
  terms (``test_jax_sums_bf16_bias_gradients_in_bf16``). The port sums them
  in fp32 and rounds once, so it lies nearer to ``r``; the rule asks for
  no more than that. Measured: 1.01 (SLATE, ``dvae.encoder.1.conv.bias``)
  beyond the floors here, up to 1.9 over other seeds and sizes; the loss
  metrics 0.0024 of JAX's distance.
- The parameters after that update: each side's are Adam's first step of
  its own clipped gradient, replayed in float64 (float32's rounding of it,
  as ``chip_smoke.adam_replay_gap``), so they differ only through the
  gradients held above; and where both gradients share a sign, exceed 100
  eps, and the lr step exceeds 1e3 ulps of the parameter, the change over
  lr agrees within 2e-2 (Adam's first step g / (|g| + eps) of two gradients
  of one sign above 100 eps differs by at most 2 eps / min |g|).
- ``hard=True``: the token ids of both sides agree on every row whose two
  largest logits + g lie more than STAGE_ULPS bf16 ulps of the logits'
  scale apart (a move of a bf16 logit by that much can flip only a nearer
  tie), and on all but STAGE_SHARE of the rows.
- The policy call and one PPO update (``train_sb3 ocr=slate
  ocr.amp=bf16``'s policy at small width): logits, values and the loss
  metrics within PPO_SAME of JAX's amp-to-fp32 distance plus the fp32 rule
  of tests/test_torch_rl.py (1e-5 of max(|x|, 1)): the same bf16 path
  (measured 0.005 of it at most). Every parameter after the update no
  farther from the fp32 update than GRAD_C times JAX's, plus 1e-5 of
  max(|leaf|, 1e-2): PPO's Adam (eps 1e-5) turns the CNN's bias gradients,
  which JAX sums in bf16, into steps that differ where |g| nears eps
  (the first block's bias lies 0.2 of JAX's distance from it).

Every entry point with an ``ocr`` group is run once at small size with the
flag, its conv blocks' outputs held to bf16. Cost: one jitted JAX
value-and-grad each for SLATE and Slot-Attention at obs 16, one jit per
stage call, one JAX PPO (its init and update jitted) and seven small runs
of the port's entry points: about 65 s alone, the imports included.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ocrl_tpu.config import compose
from ocrl_tpu.models import build_spec
from ocrl_tpu.models.base import clip_by_total_norm
from ocrl_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.models import SLATE_Module, create_ocr
from ocrl_tpu_torch.models.common import Conv2dBlock
from ocrl_tpu_torch.models.slate import compute_dtype
from ocrl_tpu_torch.rl import PPO, build_policy
from ocrl_tpu_torch.utils import checkpoint as tck
from ocrl_tpu_torch.utils.convert import attention_heads, from_flax, ocr_from_flax, ocr_to_flax

from test_slate import TINY
from test_torch_models import SMALL_JAX, small_port_config
from test_torch_rl import Pair, rollout, slate_noise

STAGE_ULPS, STAGE_SHARE = 2.0, 0.1
SAME_PATH, FP32_TOL = 0.05, 1e-5
GRAD_C, HALF_BF16_ULP, GRAD_FLOOR = 2.0, 2.0 ** -8, 1e-7
PPO_SAME, PARAM_FLOOR = 0.1, 1e-2
EPS, B1 = 1e-8, 0.9                 # Adam's eps and b1, as optax's and torch's
B = 2
TINY_F32 = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small ops on one thread, as in tests/test_torch_multi_seed.py:
    under the tier-1 run's six workers a pool of torch threads in each spins
    against the others'. The thread count is put back after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def argv(name: str = "slate", obs: int = 16, amp: bool = True) -> list[str]:
    """``TINY`` (both composes read it) for ``ocr=name`` at ``obs``, dropout
    0 (the frameworks' dropout streams differ), with or without amp."""
    return ([a.replace("ocr=slate", f"ocr={name}") for a in TINY]
            + [f"dataset.obs_size={obs}", "ocr.learning.dropout=0.0"]
            + (["ocr.amp=bf16"] if amp else []))


def ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def is_bf16(x: np.ndarray) -> bool:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return bool(torch.equal(t, t.to(torch.bfloat16).float()))


class Sides:
    """One model at one size: JAX's module of the config, the port's OCR
    with amp (seed 0) and, on the same weights, without amp (the fp32
    reference); JAX's params are the port's weights. The stage tests only
    read these two OCRs; an update takes fresh ones (``ocrs``)."""

    def __init__(self, name: str, obs: int):
        jcfg = compose("train_ocr", argv(name, obs))
        self.spec = build_spec(jcfg.ocr, jcfg.dataset)
        self.cfg = tcfg.compose(tcfg.TrainOCRConfig(), argv(name, obs))
        self.port, self.ref = self.ocrs()
        self.start = {k: v.clone() for k, v in self.port.module.state_dict().items()}
        self.params = ocr_to_flax(self.start, attention_heads(self.port.module))

    def ocrs(self):
        """(the port's OCR with amp, the same without), seed 0's weights."""
        return tuple(create_ocr(tcfg.replace(self.cfg.ocr, "amp", amp), self.cfg.dataset,
                                seed=0, device="cpu") for amp in ("bf16", None))

    def jax(self, fn, *args, **kwargs):
        """``fn(module, *args)`` on JAX's module with the params, jitted
        (one compile, where an un-jitted call compiles op by op)."""
        apply = jax.jit(lambda params, *a: self.spec.module.apply(
            {"params": params}, *a, method=fn, **kwargs))
        return apply(self.params, *args)


_SIDES: dict = {}


def sides(name: str, obs: int) -> Sides:
    """Each model built once a worker (the whole-model fixtures reuse it)."""
    if (name, obs) not in _SIDES:
        _SIDES[name, obs] = Sides(name, obs)
    return _SIDES[name, obs]


def stage_inputs(obs: int, vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    logits = 3 * rng.standard_normal((B, obs // 4, obs // 4, vocab)).astype(np.float32)
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return {"obs": rng.random((B, obs, obs, 3)).astype(np.float32),
            "z": (z / z.sum(-1, keepdims=True)).astype(np.float32),
            "slots": rng.standard_normal((B, 3, 32)).astype(np.float32)}


STAGES = {   # name: (JAX method, input, the port's module -> callable)
    "dvae-encoder": (lambda m, x: m.dvae.encode_logits(x), "obs",
                     lambda mod: mod.dvae.encode_logits),
    "dvae-decoder": (lambda m, x: m.dvae.decode(x), "z", lambda mod: mod.dvae.decode),
    "cnn-encoder": (lambda m, x: m.enc(x), "obs", lambda mod: mod.enc),
    "broadcast-decoder": (lambda m, x: m.bcdec(x), "slots", lambda mod: mod.bcdec),
}


def test_conv_rounds_as_flax_does():
    """One bf16 convolution with a non-zero bias through ``conv_nhwc``
    equals flax's ``nn.Conv(dtype=bfloat16)`` bitwise on the CPU: the fp32
    sum rounded to bf16, then the bias added and rounded again. With the
    bias inside the convolution (one rounding) the outputs differ."""
    import flax.linen as nn
    import torch.nn.functional as F

    from ocrl_tpu_torch.models.common import conv2d, conv_nhwc

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    conv = conv2d(16, 16, 5, 1, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(0.1 * rng.standard_normal((16, 16, 5, 5))))
        conv.bias.copy_(torch.from_numpy(0.3 * rng.standard_normal(16)))
    params = {"params": {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                         "bias": conv.bias.detach().numpy()}}
    want = nn.Conv(16, (5, 5), padding=[(2, 2), (2, 2)], dtype=jnp.bfloat16).apply(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = conv_nhwc(conv, xt, torch.bfloat16)
        fused = F.conv2d(xt.permute(0, 3, 1, 2).bfloat16(), conv.weight.bfloat16(),
                         conv.bias.bfloat16(), padding=2).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert not torch.equal(fused, got)


@pytest.mark.parametrize("obs", [16, 64])
@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_jax(stage, obs):
    side = sides("slotattention", obs)
    jfn, key, port_fn = STAGES[stage]
    x = stage_inputs(obs, side.cfg.ocr.dvae.vocab_size)[key]
    want, inter = side.jax(jfn, jnp.asarray(x), capture_intermediates=True)
    want = np.asarray(want)
    held = {}
    block = side.port.module.bcdec.rest[1]       # the last bf16 block of the decoder
    hook = block.register_forward_hook(lambda m, i, out: held.setdefault("block", out))
    try:
        with torch.no_grad():
            got = port_fn(side.port.module)(torch.from_numpy(x)).numpy()
            ref = port_fn(side.ref.module)(torch.from_numpy(x)).numpy()
    finally:
        hook.remove()
    assert got.dtype == want.dtype == np.float32
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - want).max())
    assert err <= STAGE_ULPS * ulp(scale), (err, ulp(scale))
    # amp really on: the fp32 stage lies farther from JAX's than the port's
    assert err < float(np.abs(ref - want).max())
    if stage == "broadcast-decoder":
        jblock = np.asarray(inter["intermediates"]["bcdec"]["rest"]["layers_1"]["__call__"][0])
        got, want = held["block"].float().numpy(), jblock.astype(np.float32)
        assert held["block"].dtype == torch.bfloat16 and jblock.dtype == jnp.bfloat16
        assert float(np.abs(got - want).max()) <= STAGE_ULPS * ulp(float(np.abs(want).max()))
    assert is_bf16(got) and is_bf16(want)
    assert np.mean(got != want) <= STAGE_SHARE


def test_hard_sample_agrees_but_at_near_ties(monkeypatch):
    """The dVAE's ``hard=True`` path: JAX's one-hot of argmax((logits + g) /
    tau) against the port's on the same Gumbel field."""
    side = sides("slate", 16)
    obs = stage_inputs(16, side.cfg.ocr.dvae.vocab_size)["obs"]
    rows = B * (16 // 4) ** 2
    e = np.random.default_rng(3).exponential(size=(rows, side.cfg.ocr.dvae.vocab_size))
    e = e.astype(np.float32).reshape(B, 4, 4, -1)
    monkeypatch.setattr(jax.random, "exponential",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(e))
    z_want, logits_want = side.jax(lambda m, x: m.dvae(x, 0.5, True), jnp.asarray(obs),
                                   rngs={"noise": jax.random.PRNGKey(0)})
    noise = torch.from_numpy(-np.log(e + TINY_F32)).reshape(rows, -1)
    with torch.no_grad():
        z_got, logits_got = side.port.module.dvae(torch.from_numpy(obs), 0.5, True, noise=noise)
    ids_want = np.asarray(z_want).reshape(rows, -1).argmax(-1)
    ids_got = z_got.numpy().reshape(rows, -1).argmax(-1)
    logits = np.asarray(logits_want).reshape(rows, -1)
    keyed = np.sort(logits - np.log(e.reshape(rows, -1) + TINY_F32), -1)
    clear = keyed[:, -1] - keyed[:, -2] > STAGE_ULPS * ulp(float(np.abs(logits).max()))
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids_got[clear], ids_want[clear])
    assert np.mean(ids_got == ids_want) >= 1 - STAGE_SHARE
    assert is_bf16(logits_got.numpy()) and z_got.dtype == torch.float32


class Update:
    """One update of one model on both sides, on the same batch and draws:
    metrics, raw (unclipped) gradients, the parameters after it (JAX's by
    its own optax chain on its gradients), and the fp32 reference's."""

    def __init__(self, name: str, seed: int = 0):
        self.side = side = sides(name, 16)
        rng = np.random.default_rng(seed)
        V = side.cfg.ocr.dvae.vocab_size
        self.obs = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
        e = [rng.exponential(size=(B * 16, V)).astype(np.float32) for _ in range(2)]
        slots = rng.standard_normal((B, 3, 32)).astype(np.float32)
        self.noise = {"soft": torch.from_numpy(-np.log(e[0] + TINY_F32)),
                      "ids": torch.from_numpy(-np.log(e[1] + TINY_F32)),
                      "slots": torch.from_numpy(slots)}
        self.jax_step(e, slots)
        self.ocr, ref = side.ocrs()
        self.port, self.ref = self.port_step(self.ocr), self.port_step(ref)

    def jax_step(self, e, slots):
        spec, calls = self.side.spec, []

        def exponential(key, shape, dtype=jnp.float32):
            calls.append(shape)
            return jnp.asarray(e[(len(calls) - 1) % 2])      # soft field, then ids field

        rngs = {s: jax.random.fold_in(jax.random.PRNGKey(0), i)
                for i, s in enumerate(spec.rng_streams)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "exponential", exponential)
            mp.setattr(jax.random, "normal",
                       lambda key, shape, dtype=jnp.float32: jnp.asarray(slots))
            grad_fn = jax.jit(jax.value_and_grad(
                lambda p, o: spec.module.apply({"params": p}, o, None, 0, True, method="loss",
                                               rngs=rngs), has_aux=True))
            (_, metrics), grads = grad_fn(self.side.params, self.obs.astype(np.float32) / 255)
        grads = jax.tree.map(np.asarray, grads)
        self.jax_metrics = {k: float(v) for k, v in metrics.items()}
        self.jax_metrics["norm"] = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads))
        self.jax_grads = {k: v.numpy() for k, v in ocr_from_flax(grads).items()}
        tx = optax.chain(clip_by_total_norm(spec.clip, spec.clip_ord), spec.optimizer)
        params = jax.tree.map(jnp.asarray, self.side.params)

        @jax.jit
        def step(grads, params):
            updates, state = tx.update(grads, tx.init(params), params)
            return optax.apply_updates(params, updates), state

        params, self.jax_state = step(grads, params)
        self.jax_params = jax.tree.map(np.asarray, params)

    def port_step(self, ocr):
        metrics = {k: float(v) for k, v in
                   ocr.update(self.obs, None, 0, noise=dict(self.noise)).items()}
        scale = min(1.0, ocr.clip / (metrics["norm"] + 1e-6))
        clipped = {k: p.grad.clone() for k, p in ocr.module.named_parameters()
                   if p.grad is not None}
        lrs = {n: g["lr"] for g in ocr.optimizer.adam.param_groups
               for n, p in ocr.module.named_parameters() if any(p is q for q in g["params"])}
        return SimpleNamespace(
            metrics=metrics, clipped=clipped, lrs=lrs,
            grads={k: (g / scale).numpy() for k, g in clipped.items()},
            params={k: v.clone() for k, v in ocr.module.state_dict().items()})


_UPDATES: dict = {}


@pytest.fixture(scope="module", params=["slate", "slotattention"])
def update(request):
    if request.param not in _UPDATES:
        _UPDATES[request.param] = Update(request.param)
    return _UPDATES[request.param]


def test_update_metrics_take_jax_s_bf16_path(update):
    got, want, ref = update.port.metrics, update.jax_metrics, update.ref.metrics
    assert set(got) == set(want)
    for key in set(want) - {"norm"}:
        err = abs(got[key] - want[key])
        assert err <= SAME_PATH * abs(want[key] - ref[key]) + FP32_TOL * max(abs(ref[key]), 1), \
            (key, got[key], want[key], ref[key])
    assert abs(got["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"])      # bf16 is on


def test_update_gradients_lie_as_near_to_fp32_as_jax_s(update):
    ref = update.ref.grads
    top = max(float(np.abs(g).max()) for g in ref.values())
    got, want = update.port.grads, update.jax_grads
    for key, w in want.items():
        if key not in got:            # a parameter the loss does not reach: zero in JAX
            assert key not in ref and not np.any(w), key
            continue
        r = ref[key]
        limit = (GRAD_C * float(np.abs(w - r).max()) + HALF_BF16_ULP * float(np.abs(r).max())
                 + GRAD_FLOOR * top)
        assert float(np.abs(got[key] - r).max()) <= limit, key
    norms = update.port.metrics["norm"], update.jax_metrics["norm"], update.ref.metrics["norm"]
    assert abs(norms[0] - norms[2]) <= GRAD_C * abs(norms[1] - norms[2]) + \
        HALF_BF16_ULP * norms[2], norms


def adam_first_step_gap(start: np.ndarray, grad: np.ndarray, lr: float,
                        after: np.ndarray) -> float:
    """``after`` against Adam's first step from ``start`` on the clipped
    ``grad``, p - lr g / (|g| + eps), replayed in float64: the worst share
    of float32's rounding of it (8 ulps of m's terms and 32 of the ratio,
    plus an ulp of the parameter before or after)."""
    unit = np.finfo(np.float32).eps
    g = grad.astype(np.float64)
    m, den, step = (1 - B1) * g, np.abs(g) + EPS, lr / (1 - B1)
    want = start.astype(np.float64) - step * m / den
    tol = step * (8 * unit * np.abs(g) + 32 * unit * np.abs(m)) / den + \
        np.spacing(np.maximum(np.abs(start), np.abs(after)))
    return float((np.abs(after - want) / tol).max())


def test_update_parameters_are_adam_of_each_side_s_gradients(update):
    side = update.side
    start = {k: v.numpy() for k, v in side.start.items()}
    jax_after = {k: v.numpy() for k, v in ocr_from_flax(update.jax_params).items()}
    jax_scale = min(1.0, side.spec.clip / (update.jax_metrics["norm"] + 1e-6))
    sure_compared = 0
    for key, lr in update.port.lrs.items():
        got = update.port.params[key].numpy()
        g = update.port.clipped.get(key)
        if g is None:                 # no gradient: the port's Adam leaves it
            np.testing.assert_array_equal(got, start[key])
            continue
        g = g.numpy()
        jg = update.jax_grads[key] * jax_scale
        assert adam_first_step_gap(start[key], g, lr, got) <= 1, key
        assert adam_first_step_gap(start[key], jg, lr, jax_after[key]) <= 1, key
        sure = ((np.sign(g) == np.sign(jg)) & (np.minimum(np.abs(g), np.abs(jg)) > 100 * EPS)
                & (lr > 1e3 * np.spacing(np.abs(start[key]))))
        moved = (got - start[key]) / lr, (jax_after[key] - start[key]) / lr
        assert float(np.abs(moved[0] - moved[1])[sure].max(initial=0.0)) <= 2e-2, key
        sure_compared += int(sure.sum())
    assert sure_compared > 0


def test_parameters_and_optimizer_state_stay_fp32(update):
    """The counterpart of tests/test_slate.py::test_slate_amp_bf16_trains_f32_params:
    after a bf16 update every parameter, gradient and Adam moment is fp32,
    while every conv block of the stacks outputs bf16 (fp32 without amp)."""
    ocr = update.ocr
    assert all(p.dtype == torch.float32 for p in ocr.module.parameters())
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in ocr.module.parameters())
    state = ocr.optimizer.adam.state
    assert state and all(v.dtype == torch.float32 for s in state.values()
                         for k, v in s.items() if k != "step")
    for amp, module in ((True, ocr.module), (False, update.side.ref.module)):
        blocks = [m for m in module.modules() if isinstance(m, Conv2dBlock)]
        dtypes = set()
        hooks = [b.register_forward_hook(lambda m, i, out: dtypes.add(out.dtype)) for b in blocks]
        try:
            with torch.no_grad():
                module.loss(torch.from_numpy(update.obs).float() / 255, None, 0,
                            noise=dict(update.noise))
        finally:
            for h in hooks:
                h.remove()
        assert blocks and dtypes == {torch.bfloat16 if amp else torch.float32}
        assert all(m.dtype == (torch.bfloat16 if amp else None) for m in blocks)


def float_leaves(tree) -> set:
    return {np.asarray(v).dtype for v in jax.tree.leaves(tree)
            if np.issubdtype(np.asarray(v).dtype, np.floating)}


def test_port_file_under_amp_loads_in_jax(update, tmp_path):
    """The port's checkpoint after the bf16 update, read by JAX's own reader
    into the template of its amp OCR: the same tree, bitwise, all fp32."""
    ocr, spec = update.ocr, update.side.spec
    tck.save(ocr, tmp_path, step=1)
    tx = optax.chain(clip_by_total_norm(spec.clip, spec.clip_ord), spec.optimizer)
    params = jax.tree.map(jnp.asarray, update.side.params)
    template = {"ocr_module_state_dict": params, "ocr_opt_state_dict": tx.init(params)}
    tree, meta = load_checkpoint(tmp_path / "checkpoints" / "model_latest.ckpt", template)
    assert meta["step"] == 1
    from flax import serialization
    got = jax.tree.map(np.asarray, serialization.to_state_dict(tree))
    want = tck.checkpoint_tree(ocr)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert float_leaves(got) == {np.dtype(np.float32)}


def test_jax_file_under_amp_loads_in_the_port(update, tmp_path):
    """JAX's parameters and optax state after its bf16 update, written by
    JAX's writer, loaded by the port's amp OCR: the same tree, bitwise; the
    loaded OCR still computes its convolutions in bf16."""
    from flax import serialization
    tree = {"ocr_module_state_dict": update.jax_params, "ocr_opt_state_dict": update.jax_state}
    path = tmp_path / "checkpoints" / "model_latest.ckpt"
    path.parent.mkdir()
    save_checkpoint(path, tree, {"step": 1, "epoch": 0, "best_val_loss": 3.0})
    ocr = create_ocr(update.side.cfg.ocr, update.side.cfg.dataset, seed=5, device="cpu")
    assert tck.load(ocr, run_dir=tmp_path) == (1, 0, 3.0)
    want = jax.tree.map(np.asarray, serialization.to_state_dict(tree))
    got = tck.checkpoint_tree(ocr)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert float_leaves(got) == {np.dtype(np.float32)}
    assert compute_dtype(ocr.module._ocr) == torch.bfloat16
    assert np.isfinite(float(ocr.update(update.obs, None, 1)["loss"]))


def test_jax_sums_bf16_bias_gradients_in_bf16():
    """A behaviour of the reference on the CPU that the port does not keep:
    the VJP of flax's bias add in a bf16 conv sums the bias gradient in bf16
    (XLA's reduce of a bf16 cotangent), so over the 2 x 64 x 64 pixels of
    the dVAE's last conv it stalls far below the sum. The port sums in fp32
    and rounds once: within half a bf16 ulp of the fp32 model's gradient."""
    side = sides("slotattention", 64)
    z = stage_inputs(64, side.cfg.ocr.dvae.vocab_size)["z"]
    target = np.random.default_rng(7).random((B, 64, 64, 3)).astype(np.float32)

    def jax_loss(params):
        recon = side.spec.module.apply({"params": params}, jnp.asarray(z),
                                       method=lambda m, x: m.dvae.decode(x))
        return jnp.sum((recon - target) ** 2)

    want = np.asarray(jax.jit(jax.grad(jax_loss))(side.params)["dvae"]["decoder_out"]["bias"])
    grads = []
    for ocr in (side.port, side.ref):
        ocr.module.zero_grad()
        recon = ocr.module.dvae.decode(torch.from_numpy(z))
        ((recon - torch.from_numpy(target)) ** 2).sum().backward()
        grads.append(ocr.module.dvae.decoder_out.bias.grad.numpy().copy())
        ocr.module.zero_grad()
    got, ref = grads
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= HALF_BF16_ULP * scale
    assert float(np.abs(want - ref).max()) > 0.3 * scale


def test_policy_call_and_ppo_update_match_jax():
    """``train_sb3 ocr=slate ocr.amp=bf16 pooling=transformer sb3=ppo`` at
    small width: one deterministic policy call on 4 observations, then one
    PPO minibatch update of 4, on JAX's and the port's policy with the same
    weights and slot noise; the fp32 port policy of those weights is ``r``."""
    noise = slate_noise(4)
    amp_cfg = tcfg.compose(tcfg.TrainSB3Config(), ["ocr=slate", "pooling=transformer",
                                                    "sb3=ppo", "sb3_acnet=mlp",
                                                    "env=target-N4C4S3S1", "ocr.amp=bf16"])
    assert amp_cfg.ocr.amp == "bf16"
    port_cfg = lambda: tcfg.replace(small_port_config(), "ocr.amp", "bf16")  # noqa: E731
    pair = Pair((SMALL_JAX + ["ocr.amp=bf16"], port_cfg, (16, 16, 3), True), noise=noise,
                batch_size=4)
    ref = PPO(build_policy(small_port_config(), seed=1, device="cpu"), (16, 16, 3), True, 2,
              tcfg.PPOConfig(batch_size=4), device="cpu")
    ref.policy.load_state_dict(pair.t.policy.state_dict())
    data = rollout(12, (16, 16, 3), True, seed=1)
    idx = np.arange(4)

    obs = torch.from_numpy(data["obs"][:4]).float() / 255
    t_noise = torch.from_numpy(noise)
    with torch.no_grad():
        got, r = pair.t.policy(obs, t_noise), ref.policy(obs, t_noise)
    with pair.patched():
        _, *want = pair.j._act_det(pair.j.params, jnp.asarray(data["obs"][:4]),
                                   jax.random.PRNGKey(0))
    for g, w, rr in zip(got, want, r):
        g, w, rr = g.numpy(), np.asarray(w), rr.numpy()
        assert float(np.abs(g - w).max()) <= PPO_SAME * float(np.abs(w - rr).max()) + \
            FP32_TOL * max(float(np.abs(rr).max()), 1)

    got_m, want_m = pair.port_update(data, idx), pair.jax_update(data, idx)
    ref_m = {k: float(v) for k, v in
             ref.update_minibatch(ref.upload(data), torch.as_tensor(idx), t_noise).items()}
    assert set(got_m) == set(want_m)
    for key, w in want_m.items():
        assert abs(got_m[key] - w) <= PPO_SAME * abs(w - ref_m[key]) + \
            FP32_TOL * max(abs(ref_m[key]), 1), key
    got_p = pair.t.policy.state_dict()
    ref_p = ref.policy.state_dict()
    for key, w in from_flax(jax.tree.map(np.asarray, pair.j.params)).items():
        w, r = w.numpy(), ref_p[key].numpy()
        floor = FP32_TOL * max(float(np.abs(w).max()), PARAM_FLOOR)
        err = float(np.abs(got_p[key].numpy() - r).max())
        assert err <= GRAD_C * float(np.abs(w - r).max()) + floor, key
    moved = {k for k in got_p if not torch.equal(got_p[k], pair.start[k])}
    assert {k for k in got_p if ".enc." in k} <= moved       # the bf16 CNN trained


@pytest.mark.parametrize("cls,groups", [
    (tcfg.TrainOCRConfig, ["dataset=random-N5C4S4S2"]),
    (tcfg.TrainSB3Config, ["pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
                           "env=target-N4C4S3S1"]),
    (tcfg.TestSB3Config, ["pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
                          "env=target-N4C4S3S1"]),
    (tcfg.TrainPropertyPredictorConfig, ["dataset=target-N4C4S3S1"]),
    (tcfg.TrainClassifierConfig, ["pooling=transformer", "dataset=target-N4C4S3S1"]),
    (tcfg.GetAriMseConfig, []),
], ids=lambda x: x.__name__ if isinstance(x, type) else None)
@pytest.mark.parametrize("ocr", ["slate", "slotattention"])
def test_compose_reads_amp_as_jax_does(cls, groups, ocr):
    """``ocr.amp`` and ``+ocr.amp`` compose in every entry point with an
    ``ocr`` group, as JAX's compose reads them (``ocr.get("amp")``), and
    mean bf16 for the string "bf16" only (ocrl_tpu/models/slate.py:56-57)."""
    entry = {tcfg.TrainOCRConfig: "train_ocr", tcfg.TrainSB3Config: "train_sb3",
             tcfg.TestSB3Config: "test_sb3",
             tcfg.TrainPropertyPredictorConfig: "train_property_predictor",
             tcfg.TrainClassifierConfig: "train_classifier",
             tcfg.GetAriMseConfig: "get_ari_mse"}[cls]
    jax_groups = groups or ["dataset=random-N5C4S4S2"]
    assert tcfg.compose(cls(), [f"ocr={ocr}"] + groups).ocr.amp is None
    for raw in ("bf16", "fp32", "null"):
        for key in ("ocr.amp", "+ocr.amp"):
            got = tcfg.compose(cls(), [f"ocr={ocr}"] + groups + [f"{key}={raw}"]).ocr
            want = compose(entry, [f"ocr={ocr}"] + jax_groups + [f"{key}={raw}"]).ocr.get("amp")
            assert got.amp == want, (key, raw)
            assert compute_dtype(got) == (torch.bfloat16 if want == "bf16" else None)
    with pytest.raises(KeyError, match="ampp"):
        tcfg.compose(cls(), [f"ocr={ocr}"] + groups + ["ocr.ampp=bf16"])


def test_amp_is_slate_s_key_only():
    """The port's other OCRs have no bf16 path (neither has JAX): their
    configs lack the key, and an unknown key raises, as every other does."""
    with pytest.raises(KeyError, match="amp"):
        tcfg.compose(tcfg.TrainOCRConfig(), ["ocr=vae", "dataset=random-N5C4S4S2",
                                             "ocr.amp=bf16"])
    module = SLATE_Module(tcfg.replace(tcfg.OCRConfig(), "amp", "bf16"), tcfg.EnvConfig(),
                          decoder=True)
    assert module.enc.dtype == module.dvae.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in module.parameters())


SMALL_RL = ["pooling=transformer", "sb3_acnet=mlp", "ocr.cnn.hidden_size=16",
            "ocr.slotattr.num_slots=3", "ocr.slotattr.slot_size=32",
            "ocr.slotattr.mlp_hidden_size=32", "pooling.d_model=32", "pooling.nhead=4",
            "num_envs=2", "vec_env=dummy", "eval.freq=1000"]
SMALL_OCR = ["ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=5", "ocr.slotattr.slot_size=32",
             "ocr.slotattr.mlp_hidden_size=32", "ocr.dvae.vocab_size=32", "ocr.dvae.d_model=32",
             "ocr.tfdec.num_dec_blocks=2", "ocr.tfdec.num_dec_heads=2"]


def run_entry(entry: str, tmp_path):
    """One small run of ``entry`` with ``ocr.amp=bf16`` on the CPU."""
    from ocrl_tpu_torch import (get_ari_mse, train_classifier, train_ocr,
                                train_property_predictor, train_sb3)
    from ocrl_tpu_torch.config import read_env_config
    from ocrl_tpu_torch.data.collect import collect_dataset

    amp = ["ocr.amp=bf16", f"run_dir={tmp_path}/run"]
    if entry.startswith(("ppo", "a2c", "sac")):
        rl = {"ppo-seeds": ["ocr=slate", "sb3=ppo", "env=target-N4C4S3S1", "env.obs_size=16",
                            "sb3.algo_kwargs.n_steps=32", "sb3.algo_kwargs.batch_size=16",
                            "sb3.algo_kwargs.n_epochs=1", "max_steps=32", "seeds=1,2"],
              "a2c": ["ocr=slotattention", "sb3=a2c", "env=target-N4C4S3S1",
                      "env.obs_size=16", "max_steps=20"],
              "sac": ["ocr=slate", "sb3=sac", "env=cw-target-N4C4S1S1",
                      "env.use_fake_sim=true", "max_steps=40", "video.length=4",
                      "sb3.algo_kwargs.learning_starts=20", "sb3.algo_kwargs.batch_size=8",
                      "sb3.algo_kwargs.buffer_size=100"]}[entry]
        return train_sb3.main(rl + SMALL_RL + amp, device="cpu")["metrics"]
    env = "random-N5C4S4S2" if entry in ("train_ocr", "get_ari_mse") else "target-N4C4S3S1"
    data = tmp_path / "ds.hdf5"
    collect_dataset(tcfg.replace(read_env_config(env), "obs_size", 16), 8, 4,
                    with_masks=True, with_labels=True, with_states=True, out_file=data)
    dataset = [f"dataset={env}", "dataset.obs_size=16", f"dataset.datadir={data}",
               "batch_size=4"]
    if entry == "train_ocr":
        return train_ocr.main(["ocr=slate", *SMALL_OCR, *dataset, "superbatch=2",
                               "max_steps=2", "eval_interval=100", *amp], device="cpu")
    if entry == "get_ari_mse":
        from ocrl_tpu_torch.data import H5Dataset
        cfg = tcfg.compose(tcfg.GetAriMseConfig(), ["ocr=slate", *SMALL_OCR,
                                                    "dataset.obs_size=16", "batch_size=4",
                                                    "ocr.amp=bf16"])
        val = H5Dataset(data, "ValidationSet")
        batch = val.read_slice(0, 4)
        return get_ari_mse.evaluate_arrays(cfg, {"obss": batch["obss"], "masks": batch["masks"]},
                                           device="cpu")
    if entry == "train_property_predictor":
        return train_property_predictor.main(["ocr=slate", *SMALL_OCR, *dataset,
                                              "max_epochs=1", *amp], device="cpu")
    return train_classifier.main(["ocr=slate", *SMALL_OCR, "pooling=transformer",
                                  "pooling.d_model=32", "pooling.nhead=4", *dataset,
                                  "max_epochs=1", *amp], device="cpu")


@pytest.mark.parametrize("entry", ["ppo-seeds", "a2c", "sac", "train_ocr", "get_ari_mse",
                                   "train_property_predictor", "train_classifier"])
def test_entry_points_run_the_conv_stacks_in_bf16(entry, tmp_path):
    """``ocr.amp=bf16`` reaches the OCR that each entry point builds: every
    conv block it runs (vmapped over seeds, end to end, frozen) outputs bf16,
    and the run's results are finite."""
    dtypes = set()

    def hook(module, args, out):
        if isinstance(module, Conv2dBlock):
            dtypes.add(out.dtype)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        result = run_entry(entry, tmp_path)
    finally:
        handle.remove()
    assert dtypes == {torch.bfloat16}, dtypes
    values = [v for v in result.values() if isinstance(v, (int, float))] \
        if isinstance(result, dict) else []
    assert values and all(np.isfinite(v) for v in values), result
