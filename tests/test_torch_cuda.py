"""Card-only tests of the port's kernels: each kernel against its plain
version on the GPU. They import no JAX, so they also run on a machine with
the card and without JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a GPU they skip. Sums are reordered between kernel and plain
version, so each sweep output is held to 1e-5 of its largest entry; the
soft Gumbel sample (values in [0, 1]) to 1e-5 absolute; token ids exactly,
since both sides add the same fp32 logits and field; each drawn field to
1e-5 of its exact numpy replay at every value (about five fp32 ulps at the
largest g, 16.64). The sweep kernels sum in a fixed order (no atomics), so
two launches on the same inputs are held to bitwise equality. The other
OCRs and poolings (no kernel of their own), and the pretraining steps of
VAE, MAE and IODINE and IODINE's evaluation, are held card against CPU.
The data path's prefetch gives on the card exactly the items it gives on
the CPU, train_ocr.main at small SLATE widths trains, evaluates, saves
and resumes on the card through B1-B4, and get_ari_mse's command line
scores a chunked, LZF-compressed file through B1-B3. One SAC update is held card against
CPU, end to end and frozen. With ``ocr.amp=bf16`` the conv blocks output
bf16 on the card and one step is held against the CPU's bf16 and fp32
steps (chip_smoke.check_amp_step). The heads kernels take every head count
up to 8, every S up to 32 and D of 21, 100 and 512, under torch.func.vmap
too, every tile and variant of their plan (ops.slot_routing.PLAN_SHAPES);
the streamed plan takes chip_smoke.WIDE_SHAPES (past 32 slots, past shared
memory) and agrees with the other two plans where they run; SlotAttention's
three routes behave on the card as on the CPU, past 32 slots too."""

import math

import numpy as np
import pytest
import torch

from ocrl_tpu_torch.ops import LAUNCHES, gumbel, reset_launches
from ocrl_tpu_torch.ops import slot_routing as tsr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4096, 5, 192), (4, 4096, 5, 192), (20, 4096, 5, 192),
                                   (256, 4096, 5, 192), (2, 4096, 6, 192), (3, 333, 5, 192),
                                   (2, 100, 16, 64)])
def test_sweep_kernel_matches_plain_on_the_card(cuda, shape):
    B, N, S, D = shape
    rng = np.random.default_rng(1)
    k = torch.from_numpy((rng.standard_normal((B, N, D)) * D ** -0.5)
                         .astype(np.float32)).cuda()
    v = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32)).cuda()
    reset_launches()
    got = tsr.route_sweep(k, v, q)
    want = tsr.route_sweep_reference(k, v, q)
    torch.cuda.synchronize()
    assert LAUNCHES == {tsr.KERNEL: 1}
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_requires_grad"])
def test_sweep_without_a_graph_keeps_nothing_on_the_card(cuda, mode):
    """Where no graph is recorded (serving, acting), route_sweep launches B3
    once, its outputs have no grad_fn, and with ``a`` dropped the card holds
    only S_a and A_v beyond its inputs: nothing that the Function saved
    outlives the call."""
    B, N, S, D = 16, 4096, 5, 192
    gen = torch.Generator(device="cuda").manual_seed(4)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "no_input_requires_grad": torch.enable_grad}[mode]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reset_launches()
    with context():
        sa, av, a = tsr.route_sweep(k * D ** -0.5, v, q)
    assert LAUNCHES == {tsr.KERNEL: 1}
    assert sa.grad_fn is None and av.grad_fn is None and a.grad_fn is None
    a_bytes = a.nbytes
    del a
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < a_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 4096, 5, 192), (32, 4096, 5, 192), (256, 4096, 5, 192),
                                   (3, 333, 5, 192), (2, 100, 16, 64)])
def test_sweep_gradient_goes_through_the_backward_kernel(cuda, shape):
    """Autograd through route_sweep on the card launches B4 once and gives
    the gradients of the plain sweep for the same cotangents."""
    B, N, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    k = k * D ** -0.5
    cot = [torch.randn(s, device="cuda", generator=gen)
           for s in ((B, S), (B, S, D), (B, N, S))]
    leaves = [x.clone().requires_grad_() for x in (k, v, q)]
    reset_launches()
    got = torch.autograd.grad(tsr.route_sweep(*leaves), leaves, cot)
    assert LAUNCHES == {tsr.KERNEL: 1, tsr.BWD_KERNEL: 1}
    plain = [x.clone().requires_grad_() for x in (k, v, q)]
    want = torch.autograd.grad(tsr.route_sweep_reference(*plain), plain, cot)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 16, 4096, 5, 192), (2, 3, 333, 5, 192)])
def test_sweep_vmap_rule_launches_once_for_all_seeds(cuda, shape):
    """Under torch.func.vmap, and vmap of a vjp, over V seeds the sweep
    launches B3 (and B4) once at V * B rows; the outputs and gradients lie
    within 1e-5 of the largest entry from V separate launches, the
    tolerance of the kernels against their plain versions: the folded launch
    splits the tokens over other blocks, so its sums over 4096 tokens run in
    another order (gq lay 1.4e-6 of its largest entry apart on an H100)."""
    from torch.func import vjp, vmap

    V, B, N, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(8)
    k, v, q = (torch.randn(sh, device="cuda", generator=gen)
               for sh in ((V, B, N, D), (V, B, N, D), (V, B, S, D)))
    k = k * D ** -0.5
    cot = [torch.randn(sh, device="cuda", generator=gen)
           for sh in ((V, B, S), (V, B, S, D), (V, B, N, S))]
    reset_launches()
    with torch.no_grad():
        outs = vmap(tsr.route_sweep)(k, v, q)
    assert LAUNCHES == {tsr.KERNEL: 1}
    reset_launches()
    grads = vmap(lambda k, v, q, *c: vjp(tsr.route_sweep, k, v, q)[1](c))(k, v, q, *cot)
    assert LAUNCHES == {tsr.KERNEL: 1, tsr.BWD_KERNEL: 1}
    reset_launches()
    for i in range(V):
        leaves = [x[i].clone().requires_grad_() for x in (k, v, q)]
        want_outs = tsr.route_sweep(*leaves)
        want = torch.autograd.grad(want_outs, leaves, [c[i] for c in cot])
        for g, w in zip((*outs, *grads), (*want_outs, *want)):
            assert (g[i] - w).abs().max() <= 1e-5 * w.abs().max()
    assert LAUNCHES == {tsr.KERNEL: V, tsr.BWD_KERNEL: V}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 4096, 5, 192), (3, 333, 5, 192),
                                   (2, 100, 16, 64)])
def test_sweep_kernels_are_deterministic_on_the_card(cuda, shape):
    """B3 and B4 launched twice on the same inputs give bitwise-equal
    outputs; S_a, A_v and gq, summed across blocks inside the kernels, agree
    with the plain sweep and its autograd."""
    B, N, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    k = k * D ** -0.5
    g_av = torch.randn(B, S, D, device="cuda", generator=gen)
    g_a = torch.randn(B, N, S, device="cuda", generator=gen)
    first = tsr.route_sweep(k, v, q)
    second = tsr.route_sweep(k, v, q)
    a = first[2]
    grads = [tsr._sweep_bwd(k, v, q, a, g_av, g_a) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    want_sa, want_av, _ = tsr.route_sweep_reference(k, v, q)
    for got, want in ((first[0], want_sa), (first[1], want_av)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    leaves = [x.clone().requires_grad_() for x in (k, v, q)]
    outs = tsr.route_sweep_reference(*leaves)
    want_gq = torch.autograd.grad(outs, leaves[2], (torch.zeros_like(want_sa), g_av, g_a))[0]
    assert (grads[0][2] - want_gq).abs().max() <= 1e-5 * want_gq.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 256])
def test_sweep_takes_every_slot_count_on_the_card(cuda, D):
    """The C entry chooses each kernel's tile from the shared memory it
    needs: at the narrowest and the widest D, every S from 1 to 16 launches
    B3 and B4 and matches the plain sweep and its autograd. 3 x 37 tokens,
    so that for most S the last tile's a and g_a end off a 16-byte boundary
    (the 1-3 floats the backward reads with plain loads)."""
    B, N = 3, 37
    gen = torch.Generator(device="cuda").manual_seed(7)
    for S in range(1, 17):
        k, v, q = (torch.randn(s, device="cuda", generator=gen)
                   for s in ((B, N, D), (B, N, D), (B, S, D)))
        k = k * D ** -0.5
        cot = [torch.randn(s, device="cuda", generator=gen)
               for s in ((B, S), (B, S, D), (B, N, S))]
        leaves = [x.clone().requires_grad_() for x in (k, v, q)]
        reset_launches()
        outs = tsr.route_sweep(*leaves)
        got = torch.autograd.grad(outs, leaves, cot)
        assert LAUNCHES == {tsr.KERNEL: 1, tsr.BWD_KERNEL: 1}, S
        plain = [x.clone().requires_grad_() for x in (k, v, q)]
        want_outs = tsr.route_sweep_reference(*plain)
        want = torch.autograd.grad(want_outs, plain, cot)
        torch.cuda.synchronize()
        for g, w in zip((*outs, *got), (*want_outs, *want)):
            assert (g - w).abs().max() <= 1e-5 * w.abs().max(), S


def _entries(S, D, H):
    """The launch counters of the C entry pair that takes the shape."""
    return {"fast": (tsr.KERNEL, tsr.BWD_KERNEL),
            "heads": (tsr.HEADS_KERNEL, tsr.HEADS_BWD_KERNEL),
            "wide": (tsr.WIDE_KERNEL, tsr.WIDE_BWD_KERNEL)}[tsr.sweep_plan(S, D, H)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,D", [(1, 21), (3, 21), (7, 21), (1, 100), (2, 100), (4, 100),
                                 (1, 512), (2, 512), (4, 512), (8, 512)])
def test_sweep_takes_every_head_and_slot_count_on_the_card(cuda, H, D):
    """Every S from 1 to 32 at H heads of D / H columns (D = 21: heads of 7
    and 3 columns, no 16-byte rows) launches one B3 and one B4 of the entry
    pair that takes the shape and matches the plain sweep and its autograd
    to 1e-5 of each output's largest entry; 3 x 37 tokens, so that tiles
    and the spans of a and g_a end off 16-byte boundaries."""
    B, N = 3, 37
    gen = torch.Generator(device="cuda").manual_seed(9)
    for S in range(1, 33):
        k, v, q = (torch.randn(s, device="cuda", generator=gen)
                   for s in ((B, N, D), (B, N, D), (B, S, D)))
        k = k * (D // H) ** -0.5
        cot = [torch.randn(s, device="cuda", generator=gen)
               for s in ((B, H * S), (B, S, D), (B, N, H * S))]
        leaves = [x.clone().requires_grad_() for x in (k, v, q)]
        reset_launches()
        outs = tsr.route_sweep(*leaves, H)
        got = torch.autograd.grad(outs, leaves, cot)
        fwd, bwd = _entries(S, D, H)
        assert LAUNCHES == {fwd: 1, bwd: 1}, S
        plain = [x.clone().requires_grad_() for x in (k, v, q)]
        want_outs = tsr.route_sweep_reference(*plain, H)
        want = torch.autograd.grad(want_outs, plain, cot)
        torch.cuda.synchronize()
        for g, w in zip((*outs, *got), (*want_outs, *want)):
            assert (g - w).abs().max() <= 1e-5 * w.abs().max(), S


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 4096, 5, 4, 192), (24, 4096, 24, 1, 256),
                                   (2, 333, 32, 8, 512), (3, 37, 5, 3, 21)])
def test_heads_kernels_are_deterministic_on_the_card(cuda, shape):
    """The heads kernels, launched twice on the same inputs, give bitwise
    equal outputs and gradients (row sums in block order, no atomics)."""
    B, N, S, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(10)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    k = k * (D // H) ** -0.5
    g_av = torch.randn(B, S, D, device="cuda", generator=gen)
    g_a = torch.randn(B, N, H * S, device="cuda", generator=gen)
    first, second = (tsr.route_sweep(k, v, q, H) for _ in range(2))
    grads = [tsr._sweep_bwd(k, v, q, first[2], g_av, g_a, H) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.equal(x, y) for x, y in zip(*grads))


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,D", tsr.PLAN_SHAPES)
def test_heads_plans_launch_every_tile_and_variant_on_the_card(cuda, S, H, D):
    """PLAN_SHAPES take between them every tile, stage count, chunk width,
    lane count and variant of the heads plan. At each, the plans the C
    entries choose on the card equal the wrapper's mirror, and B3' and B4'
    over 2 rows of 2 T + 5 tokens (tiles and rows that end off 16-byte
    boundaries, blocks that meet two rows) match the plain sweep and its
    autograd within 1e-5 of each output's largest entry, and a second
    launch gives bitwise the same outputs."""
    fwd, bwd, _, _ = tsr.card_plans(S, D, H)
    assert (fwd, bwd) == (tsr.heads_plan(S, D, H, True), tsr.heads_plan(S, D, H, False))
    B, N = 2, 2 * max(fwd.T, bwd.T) + 5
    gen = torch.Generator(device="cuda").manual_seed(12)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    k = k * (D // H) ** -0.5
    cot = [torch.randn(s, device="cuda", generator=gen)
           for s in ((B, H * S), (B, S, D), (B, N, H * S))]
    reset_launches()
    outs = tsr.route_sweep(k, v, q, H)
    g_a = (cot[2] + cot[0][:, None, :]).contiguous()
    grads = tsr._sweep_bwd(k, v, q, outs[2], cot[1], g_a, H)
    assert LAUNCHES == {tsr.HEADS_KERNEL: 1, tsr.HEADS_BWD_KERNEL: 1}
    plain = [x.clone().requires_grad_() for x in (k, v, q)]
    want_outs = tsr.route_sweep_reference(*plain, H)
    want = torch.autograd.grad(want_outs, plain, cot)
    again = (*tsr.route_sweep(k, v, q, H), *tsr._sweep_bwd(k, v, q, outs[2], cot[1], g_a, H))
    torch.cuda.synchronize()
    for g, w, y in zip((*outs, *grads), (*want_outs, *want), again):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
        assert torch.equal(g, y)


# chip_smoke.WIDE_SHAPES, [B, N, S, H, D]: past 32 slots, past shared
# memory, the widest H S of the logits' epilogue and one past it, 96 slots
WIDE_SHAPES = [(24, 4096, 64, 1, 192), (24, 4096, 33, 1, 192), (2, 333, 32, 8, 2048),
               (2, 40, 5, 1, 8192), (3, 37, 65, 5, 35), (24, 4096, 128, 1, 192),
               (24, 4096, 129, 1, 192), (24, 4096, 96, 1, 192)]


def _sweep_inputs(shape, seed):
    B, N, S, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    cot = [torch.randn(s, device="cuda", generator=gen)
           for s in ((B, H * S), (B, S, D), (B, N, H * S))]
    return (k * (D // H) ** -0.5, v, q), cot


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_streamed_plan_matches_plain_on_the_card(cuda, shape):
    """The streamed plan at WIDE_SHAPES: route_sweep and its gradient launch
    slot_routing_wide_fwd and _bwd once each and match the plain sweep and
    its autograd within 1e-5 of each output's largest entry; a second launch
    of each gives bitwise the same outputs (segments summed in order, no
    atomics)."""
    B, N, S, H, D = shape
    assert tsr.sweep_plan(S, D, H) == "wide"
    inputs, cot = _sweep_inputs(shape, 13)
    leaves = [x.clone().requires_grad_() for x in inputs]
    reset_launches()
    outs = tsr.route_sweep(*leaves, H)
    got = torch.autograd.grad(outs, leaves, cot)
    assert LAUNCHES == {tsr.WIDE_KERNEL: 1, tsr.WIDE_BWD_KERNEL: 1}
    plain = [x.clone().requires_grad_() for x in inputs]
    want_outs = tsr.route_sweep_reference(*plain, H)
    want = torch.autograd.grad(want_outs, plain, cot)
    g_a = (cot[2] + cot[0][:, None, :]).contiguous()
    again = (*tsr.route_sweep(*inputs, H),
             *tsr._sweep_bwd(*inputs, outs[2].detach(), cot[1], g_a, H))
    torch.cuda.synchronize()
    for g, w, y in zip((*outs, *got), (*want_outs, *want), again):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
        assert torch.equal(g, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 64, 1, 192), (3, 200, 33, 1, 96)])
def test_streamed_epilogues_agree_on_the_card(cuda, shape, monkeypatch):
    """At one shape, the streamed entries on the card's SM count (few
    blocks: the columns cut into pieces, the softmax and dl in the row
    kernels) and planned for one SM (the softmax and dl in the logits'
    epilogue) give outputs and gradients within 1e-5 of each other's and
    the plain version's largest entries."""
    B, N, S, H, D = shape
    inputs, cot = _sweep_inputs(shape, 15)
    g_a = (cot[2] + cot[0][:, None, :]).contiguous()
    sms = tsr._num_sms(torch.cuda.current_device())
    plans = [tsr.wide_plan(B, N, S, D, H, n) for n in (sms, 1)]
    assert [(p.fused, p.pieces > 1) for p in plans] == [(0, True), (1, False)]
    outs = []
    for n in (sms, 1):
        monkeypatch.setattr(tsr, "_num_sms", lambda index, n=n: n)
        fwd = tsr._sweep_fwd(*inputs, H, plan="wide")
        outs.append((*fwd, *tsr._sweep_bwd(*inputs, fwd[2], cot[1], g_a, H, plan="wide")))
    leaves = [x.clone().requires_grad_() for x in inputs]
    want = tsr.route_sweep_reference(*leaves, H)
    want = (*want, *torch.autograd.grad(want[1:], leaves, (cot[1], g_a)))
    torch.cuda.synchronize()
    for rows, epilogue, w in zip(*outs, want):
        scale = w.abs().max()
        assert (rows - epilogue).abs().max() <= 1e-5 * scale
        assert (rows - w).abs().max() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 4096, 5, 4, 192), (24, 4096, 5, 1, 192),
                                   (3, 37, 24, 1, 256)])
def test_streamed_plan_agrees_with_the_other_plans_on_the_card(cuda, shape):
    """The streamed entries forced at shapes the single-head or the heads
    entries take hold to those entries' outputs and gradients within 1e-5
    of each output's largest entry."""
    B, N, S, H, D = shape
    inputs, cot = _sweep_inputs(shape, 14)
    g_a = (cot[2] + cot[0][:, None, :]).contiguous()
    reset_launches()
    wide = tsr._sweep_fwd(*inputs, H, plan="wide")
    wide_grads = tsr._sweep_bwd(*inputs, wide[2], cot[1], g_a, H, plan="wide")
    other = tsr._sweep_fwd(*inputs, H)
    other_grads = tsr._sweep_bwd(*inputs, other[2], cot[1], g_a, H)
    fwd, bwd = _entries(S, D, H)
    assert LAUNCHES == {tsr.WIDE_KERNEL: 1, tsr.WIDE_BWD_KERNEL: 1, fwd: 1, bwd: 1}
    assert fwd != tsr.WIDE_KERNEL
    torch.cuda.synchronize()
    for g, w in zip((*wide, *wide_grads), (*other, *other_grads)):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 16, 4096, 5, 4, 192), (2, 3, 37, 24, 1, 256),
                                   (3, 2, 37, 33, 1, 64)])
def test_sweep_vmap_rule_with_heads_launches_once(cuda, shape):
    """torch.func.vmap, and vmap of a vjp, of the sweep with heads (or past 32
    slots: the streamed plan) over V seeds launch one B3 (and one B4) of the
    shape's entry pair at V * B rows, within 1e-5 of each output's largest
    entry from V separate launches."""
    from torch.func import vjp, vmap

    V, B, N, S, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    k, v, q = (torch.randn(sh, device="cuda", generator=gen)
               for sh in ((V, B, N, D), (V, B, N, D), (V, B, S, D)))
    k = k * (D // H) ** -0.5
    cot = [torch.randn(sh, device="cuda", generator=gen)
           for sh in ((V, B, H * S), (V, B, S, D), (V, B, N, H * S))]
    fwd, bwd = _entries(S, D, H)
    reset_launches()
    with torch.no_grad():
        outs = vmap(lambda k, v, q: tsr.route_sweep(k, v, q, H))(k, v, q)
    assert LAUNCHES == {fwd: 1}
    reset_launches()
    grads = vmap(lambda k, v, q, *c: vjp(lambda *x: tsr.route_sweep(*x, H), k, v, q)[1](c))(
        k, v, q, *cot)
    assert LAUNCHES == {fwd: 1, bwd: 1}
    for i in range(V):
        leaves = [x[i].clone().requires_grad_() for x in (k, v, q)]
        want_outs = tsr.route_sweep(*leaves, H)
        want = torch.autograd.grad(want_outs, leaves, [c[i] for c in cot])
        for g, w in zip((*outs, *grads), (*want_outs, *want)):
            assert (g[i] - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
def test_slot_attention_routes_on_the_card(cuda):
    """SlotAttention with 4 heads on the card: auto launches the heads
    forward once an iteration, never launches nothing and lies within the
    kernel route's tolerance of it (chip_smoke.NEVER_TOL), always raises as
    JAX's does; at 33 slots auto launches the streamed forward once an
    iteration, within NEVER_TOL of never."""
    from chip_smoke import NEVER_TOL

    from ocrl_tpu_torch.models.slot_attention import SlotAttention

    torch.manual_seed(12)
    routes = {f: SlotAttention(3, 5, 64, 192, 192, 4, fused=f).cuda() for f in ("auto", "never")}
    routes["never"].load_state_dict(routes["auto"].state_dict())
    x = torch.randn(2, 4096, 64, device="cuda")
    s = torch.randn(2, 5, 192, device="cuda")
    out = {}
    for fused, module in routes.items():
        reset_launches()
        with torch.no_grad():
            out[fused] = module(x, s)
        assert LAUNCHES == ({tsr.HEADS_KERNEL: 3} if fused == "auto" else {})
    for got, want in zip(out["never"], out["auto"]):
        assert (got - want).abs().max() <= NEVER_TOL * want.abs().max()
    with pytest.raises(ValueError, match="ineligible"):
        SlotAttention(1, 5, 64, 192, 192, 4, fused="always").cuda()(x, s)
    wide = {f: SlotAttention(3, 33, 64, 64, 64, 1, fused=f).cuda() for f in ("auto", "never")}
    wide["never"].load_state_dict(wide["auto"].state_dict())
    s33 = torch.randn(2, 33, 64, device="cuda")
    for fused, module in wide.items():
        reset_launches()
        with torch.no_grad():
            out[fused] = module(x, s33)
        assert LAUNCHES == ({tsr.WIDE_KERNEL: 3} if fused == "auto" else {})
    for got, want in zip(out["never"], out["auto"]):
        assert (got - want).abs().max() <= NEVER_TOL * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6144, 4096), (1000, 512), (7, 32)])
def test_gumbel_ids_take_the_first_nan_on_the_card(cuda, shape):
    """B2 on rows with some NaN, rows of NaN only and a row of -inf, given a
    zero field: the plain version's ids exactly (the first NaN's index, as
    jnp.argmax), and no id reaches V."""
    R, V = shape
    gen = torch.Generator(device="cuda").manual_seed(6)
    logits = torch.randn(R, V, device="cuda", generator=gen)
    cols = torch.randint(0, V, (R // 2, 2), device="cuda", generator=gen)
    logits[torch.arange(R // 2, device="cuda")[:, None], cols] = float("nan")
    logits[R // 2:R // 2 + 2] = float("nan")
    logits[R - 1] = -float("inf")
    zeros = torch.zeros_like(logits)
    got = gumbel.gumbel_argmax_ids(logits, noise=zeros)
    want = gumbel.gumbel_argmax_ids_reference(logits, zeros)
    assert torch.equal(got, want)
    assert int(got.max()) < V


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6144, 4096), (1000, 512), (7, 32)])
def test_gumbel_kernels_match_plain_on_the_card(cuda, shape):
    """B1 and B2 against their plain versions fed the field each kernel
    drew (g_out); the noise entry reproduces the sample from that field."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn(shape, device="cuda", generator=gen) * 3
    g, g2 = torch.empty_like(logits), torch.empty_like(logits)
    reset_launches()
    y = gumbel.gumbel_softmax_sample(logits, 0.7, generator=gen, g_out=g)
    ids = gumbel.gumbel_argmax_ids(logits, generator=gen, g_out=g2)
    assert LAUNCHES == {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1}
    want = gumbel.gumbel_softmax_sample_reference(logits, g, 0.7)
    assert (y - want).abs().max() <= 1e-5
    assert torch.equal(ids, gumbel.gumbel_argmax_ids_reference(logits, g2))
    assert torch.equal(y, gumbel.gumbel_softmax_sample(logits, 0.7, noise=g))
    assert not torch.equal(g, g2)            # two streams


@pytest.mark.cuda
def test_gumbel_field_distribution_on_the_card(cuda):
    """The in-kernel Philox field over 6144 x 4096 draws: mean Euler's
    gamma and variance pi^2 / 6 within 8 standard errors; the ids'
    frequencies on a repeated row follow the softmax."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    logits = torch.zeros(6144, 4096, device="cuda")
    g = torch.empty_like(logits)
    gumbel.gumbel_softmax_sample(logits, 1.0, generator=gen, g_out=g)
    n = g.numel()
    g = g.double()
    assert abs(g.mean().item() - 0.5772156649015329) <= 8 * 1.2825 / math.sqrt(n)
    assert abs(g.var().item() - math.pi ** 2 / 6) <= 8 * 3.45 / math.sqrt(n)
    row = torch.full((1, 128), -1e9, device="cuda")
    row[0, :4] = torch.tensor([2.0, 1.0, 0.0, -1.0], device="cuda")
    ids = gumbel.gumbel_argmax_ids(row.repeat(65536, 1), generator=gen)
    freq = torch.bincount(ids, minlength=4)[:4].double().cpu() / 65536
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.0, -1.0], dtype=torch.float64), 0)
    assert (freq - want).abs().max() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6144, 4096), (1000, 512), (7, 32)])
def test_gumbel_fields_replay_exactly_on_the_card(cuda, shape):
    """The field each kernel drew (g_out) against gumbel.replay_field, the
    numpy replay of its Philox words from the seed the wrapper drew (itself
    replayed from the generator's state): within 1e-5 at every value, the
    right tail included."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    logits = torch.randn(shape, device="cuda", generator=gen)
    draws = ((gumbel.SOFT_STREAM, lambda g: gumbel.gumbel_softmax_sample(
                 logits, 0.5, generator=gen, g_out=g)),
             (gumbel.IDS_STREAM, lambda g: gumbel.gumbel_argmax_ids(
                 logits, generator=gen, g_out=g)))
    for stream, draw in draws:
        g = torch.empty_like(logits)
        state = gen.get_state()
        draw(g)
        seed = gumbel.replayed_seed(state, "cuda")
        exact = torch.from_numpy(gumbel.replay_field(seed, stream, *shape))
        assert (g.cpu().double() - exact).abs().max().item() <= 1e-5, stream


@pytest.mark.cuda
@pytest.mark.parametrize("bcdec", [False, True])
def test_evaluation_batch_matches_plain_on_the_card(cuda, bcdec):
    """One full-width evaluation batch of 4 painted scenes through
    get_ari_mse.evaluate launches B1, B2 once and B3 six times (the loss's
    slot attention and the generation's; Slot-Attention: B3 three times,
    no Gumbel kernel, no generation), and agrees with the same OCR on the
    plain versions under the rules of chip_smoke.py's evaluation phase
    (``check_eval``: loss metrics 1e-5 relative, ARI label maps equal but
    where an attention lies within 1e-6 of 1.0, greedy tokens equal up to
    each row's first near-tie)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import check_eval, painted
    from ocrl_tpu_torch.config import EnvConfig, OCRCheckpointConfig, OCRConfig
    from ocrl_tpu_torch.get_ari_mse import evaluate
    from ocrl_tpu_torch.utils.checkpoint import get_ocr

    ocr, _ = get_ocr(OCRConfig(use_bcdec=bcdec), EnvConfig(), OCRCheckpointConfig(), seed=0)
    obs, masks = painted(4, 64, 4, 0)
    batch = {"obss": obs, "masks": masks}
    reset_launches()
    results = evaluate(ocr, [batch], seed=1)
    torch.cuda.synchronize()
    if bcdec:
        assert LAUNCHES == {tsr.KERNEL: 3}
    else:
        assert LAUNCHES == {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1, tsr.KERNEL: 6}
    assert np.isfinite([results["ari"], results["mse"]]).all()
    assert all(check_eval(ocr, batch).values())


@pytest.mark.cuda
def test_get_ari_mse_cli_launches_the_kernels_on_a_chunked_file(cuda, tmp_path):
    """python -m ocrl_tpu_torch.get_ari_mse's main at full SLATE width on the
    committed lzf-fletcher32.h5 (chunked, LZF and fletcher32; 32 validation
    images): 4 batches of 8 launch B1 4, B2 4 and B3 24, and eval/ari and
    eval/mse are logged at step 0."""
    import json
    from pathlib import Path

    from ocrl_tpu_torch import get_ari_mse

    data = Path(__file__).resolve().parent / "data" / "hdf5" / "lzf-fletcher32.h5"
    reset_launches()
    results = get_ari_mse.main(["ocr=slate", "dataset=random-N5C4S4S2",
                                f"dataset.datadir={data}", "batch_size=8",
                                f"run_dir={tmp_path}"])
    torch.cuda.synchronize()
    assert LAUNCHES == {gumbel.SOFT_KERNEL: 4, gumbel.IDS_KERNEL: 4, tsr.KERNEL: 24}
    (logged,) = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert logged["_step"] == 0
    assert (logged["eval/ari"], logged["eval/mse"]) == (results["ari"], results["mse"])
    assert np.isfinite([results["ari"], results["mse"]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True], ids=["e2e", "frozen"])
def test_ppo_update_goes_through_the_sweep_kernels(cuda, freeze):
    """One PPO minibatch update of 8 at small SLATE widths on the card:
    end to end B3 and B4 three times each; with the OCR frozen B3 three
    times and no B4, and the OCR's parameters bitwise unchanged."""
    from ocrl_tpu_torch.config import PolicyConfig, replace
    from ocrl_tpu_torch.rl import PPO, build_policy

    cfg = PolicyConfig()
    for path, value in [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
                        ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
                        ("ocr.slotattr.mlp_hidden_size", 32), ("pooling.d_model", 32),
                        ("pooling.nhead", 4)]:
        cfg = replace(cfg, path, value)
    algo = PPO(build_policy(cfg, seed=0), (16, 16, 3), True, 1, freeze_ocr=freeze)
    rng = np.random.default_rng(0)
    batch = {"obs": rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8),
             "actions": rng.integers(0, 4, 8).astype(np.int32),
             "logprobs": np.full(8, np.log(0.25), np.float32),
             "values": np.zeros(8, np.float32),
             "advantages": rng.standard_normal(8).astype(np.float32),
             "returns": rng.standard_normal(8).astype(np.float32)}
    ocr_before = {k: v.clone() for k, v in algo.policy.ocr_module.state_dict().items()}
    data = algo.upload(batch)
    reset_launches()
    metrics = algo.update_minibatch(data, torch.arange(8, device="cuda"))
    torch.cuda.synchronize()
    want = {tsr.KERNEL: 3} if freeze else {tsr.KERNEL: 3, tsr.BWD_KERNEL: 3}
    assert LAUNCHES == want
    assert all(torch.isfinite(v) for v in metrics.values())
    same = all(torch.equal(v, ocr_before[k])
               for k, v in algo.policy.ocr_module.state_dict().items())
    assert same == freeze


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True], ids=["e2e", "frozen"])
def test_sac_update_matches_the_cpu_on_the_card(cuda, freeze):
    """One SAC update at small SLATE widths on CausalWorld images (64x64),
    batch 8, card against CPU on the same weights, batch and draws: B3 nine
    times, B4 three times end to end and never frozen; losses within 1e-5
    of max(|value|, 1); targets and moments within 1e-5 of max(|leaf|,
    1e-2); parameters so where the gradient reaches Adam's eps, and below
    it within that plus lr x the Adam step gap of the two moments
    (chip_smoke.check_sac_update's rule)."""
    from chip_smoke import adam_step_gap
    from ocrl_tpu_torch.config import TrainSB3Config, compose
    from ocrl_tpu_torch.envs.spaces import Box
    from ocrl_tpu_torch.rl import SAC, build_sac_policy

    cfg = compose(TrainSB3Config(), [
        "ocr=slate", "pooling=transformer", "sb3=sac", "env=cw-target-N4C4S1S1",
        "env.use_fake_sim=true", "ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=3",
        "ocr.slotattr.slot_size=32", "ocr.slotattr.mlp_hidden_size=32", "pooling.d_model=32",
        "pooling.nhead=4"])
    space = Box(-1.0, 1.0, (3,), np.float32)
    algos = []
    for d in ("cuda", "cpu"):
        policy = build_sac_policy(cfg, space, seed=0, device=d)[0]
        policy.freeze_ocr = freeze
        algos.append(SAC(policy, (64, 64, 3), True, 1, cfg.sb3.algo_kwargs, device=d))
    rng = np.random.default_rng(0)
    batch = {"obs": rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
             "next_obs": rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
             "actions": rng.uniform(-1, 1, (8, 3)).astype(np.float32),
             "rewards": (rng.random(8) < 0.5).astype(np.float32),
             "dones": (rng.random(8) < 0.3).astype(np.float32)}
    draws = {k: rng.standard_normal((8, 3, 32)).astype(np.float32) for k in ("slots",
                                                                            "slots_next")}
    draws.update({k: rng.standard_normal((8, 3)).astype(np.float32)
                  for k in ("eps_next", "eps_pi")})
    out = []
    for algo in algos:
        noise = {k: torch.from_numpy(v).to(algo.device) for k, v in draws.items()}
        reset_launches()
        out.append(algo.update(algo.upload(batch), noise))
        if algo.device.type == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES == ({tsr.KERNEL: 9} if freeze else {tsr.KERNEL: 9, tsr.BWD_KERNEL: 3})
    got, want = out
    for k, w in want.items():
        assert abs(got[k].item() - w.item()) <= 1e-5 * max(abs(w.item()), 1.0), k
    card, host = algos
    for a, b in ((card.target.state_dict(), host.target.state_dict()),):
        for k, w in b.items():
            assert (a[k].cpu() - w).abs().max() <= 1e-5 * max(w.abs().max().item(), 1e-2), k
    params, theirs = dict(card.policy.named_parameters()), dict(host.policy.named_parameters())
    for group, opt in card.optimizers.items():
        hopt = host.optimizers[group]
        for i, name in enumerate(card.param_names[group]):
            mu, nu = opt.mu[i].cpu(), opt.nu[i].cpu()
            for m, w in ((mu, hopt.mu[i]), (nu, hopt.nu[i])):
                assert (m - w).abs().max() <= 1e-5 * max(w.abs().max().item(), 1e-2), name
            tol = 1e-5 * max(theirs[name].abs().max().item(), 1e-2)
            gap = opt.lr * adam_step_gap(mu, nu, hopt.mu[i], hopt.nu[i], opt.count, opt.b1,
                                         opt.b2, opt.eps)
            below = hopt.mu[i].abs() < (1 - opt.b1) * opt.eps
            diff = (params[name].detach().cpu() - theirs[name].detach()).abs()
            assert (diff <= tol + torch.where(below, gap, torch.zeros_like(gap))).all(), name


SMALL_POOL = ["pooling=transformer", "pooling.d_model=32", "pooling.nhead=4"]
OTHER_OCRS = {   # small widths; the CPU tests hold each against JAX
    "naturecnn": ["ocr=naturecnn", "ocr.rep_dim=32", "pooling=identity",
                  "sb3_acnet=identity_orthoinit"],
    "naturecnn-feat": ["ocr=naturecnn", "ocr.use_cnn_feat=True", "pooling.pos_emb=ape"]
    + SMALL_POOL,
    "multiple_cnn": ["ocr=multiple_cnn", "ocr.num_modules=3", "ocr.rep_dim=32"] + SMALL_POOL,
    "vae": ["ocr=vae", "pooling=mlp"],
    "mae": ["ocr=mae", "ocr.vit_size=tiny", "ocr.patch_size=8"] + SMALL_POOL,
    "mae-cls": ["ocr=mae", "ocr.vit_size=tiny", "ocr.patch_size=8", "ocr.return_cls=True",
                "pooling=mlp"],
    "iodine": ["ocr=iodine_large", "ocr.slot_size=8", "ocr.num_iterations=3"] + SMALL_POOL,
}


def _other_config(variant):
    from ocrl_tpu_torch.config import TrainSB3Config, compose

    return compose(TrainSB3Config(), OTHER_OCRS[variant] + ["sb3=ppo", "env=target-N4C4S3S1"])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", OTHER_OCRS)
def test_other_ocr_policies_match_the_cpu_on_the_card(cuda, variant):
    """Each other OCR's policy (64x64 frames; seed 0) on the card against
    the same weights on the CPU: logits and values within 1e-5 of
    max(|value|, 1), IODINE (3 iterations, the same noise) within 1e-4;
    no kernel launched."""
    from ocrl_tpu_torch.rl import build_policy

    cfg = _other_config(variant).policy_config()
    rng = np.random.default_rng(0)
    obs = torch.from_numpy(rng.random((6, 64, 64, 3)).astype(np.float32))
    noise = None
    if cfg.ocr.name == "Iodine":
        noise = torch.from_numpy(rng.standard_normal((3, 6, 6, 8)).astype(np.float32))
    outs = []
    reset_launches()
    for device in ("cuda", "cpu"):
        policy = build_policy(cfg, seed=0, device=device)
        with torch.no_grad():
            outs.append([t.cpu() for t in policy(
                obs.to(device), noise=None if noise is None else noise.to(device))])
    assert LAUNCHES == {}
    tol = 1e-4 if noise is not None else 1e-5
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= tol * max(want.abs().max().item(), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True], ids=["e2e", "frozen"])
def test_iodine_updates_and_acts_on_the_card(cuda, freeze):
    """IODINE's forward opens autograd inside the rollout's inference_mode
    and the frozen update's no_grad on the card too: acting works, a frozen
    update leaves the OCR bitwise unchanged, an end-to-end one moves it."""
    from ocrl_tpu_torch.rl import PPO, build_policy

    cfg = _other_config("iodine")
    algo = PPO(build_policy(cfg.policy_config(), seed=0), (64, 64, 3), True, 1,
               freeze_ocr=freeze)
    rng = np.random.default_rng(1)
    batch = {"obs": rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
             "actions": rng.integers(0, 4, 8).astype(np.int32),
             "logprobs": np.full(8, np.log(0.25), np.float32),
             "values": np.zeros(8, np.float32),
             "advantages": rng.standard_normal(8).astype(np.float32),
             "returns": rng.standard_normal(8).astype(np.float32)}
    action, logprob, value = algo.act(batch["obs"][:4])
    assert action.shape == (4,) and torch.isfinite(logprob).all()
    before = {k: v.clone() for k, v in algo.policy.ocr_module.state_dict().items()}
    metrics = algo.update_minibatch(algo.upload(batch), torch.arange(8, device="cuda"))
    assert all(torch.isfinite(v) for v in metrics.values())
    same = all(torch.equal(v, before[k])
               for k, v in algo.policy.ocr_module.state_dict().items())
    assert same == freeze


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("rn", (3, 5, 16)), ("mlp", (3, 5, 16)),
                                        ("identity", (3, 5, 16)),
                                        ("cnn_linear", (2, 4096, 8)),
                                        ("cnn_transformer", (2, 4096, 8))])
def test_other_poolings_match_the_cpu_on_the_card(cuda, name, shape):
    from ocrl_tpu_torch.config import TrainSB3Config, compose
    from ocrl_tpu_torch.poolings import create_pooling_module

    cfg = compose(TrainSB3Config(), [f"pooling={name}", "ocr=gt", "env=target-N4C4S3S1"]).pooling
    torch.manual_seed(0)
    module = create_pooling_module(cfg.name, shape[2], shape[1], cfg).eval()
    state = torch.from_numpy(np.random.default_rng(2).random(shape).astype(np.float32))
    with torch.no_grad():
        want = module(state)
        got = module.cuda()(state.cuda()).cpu()
    assert (got - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1e-2)


PRETRAIN_SMALL = {"vae": ("VAEConfig", {}),
                  "mae": ("MAEConfig", {"vit_size": "tiny", "patch_size": 4}),
                  "iodine": ("IodineConfig", {"slot_size": 8, "num_iterations": 3})}


def _pretrain_config(name):
    from ocrl_tpu_torch import config

    cls, fields = PRETRAIN_SMALL[name]
    return getattr(config, cls)(**fields), config.EnvConfig(obs_size=16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PRETRAIN_SMALL)
def test_pretraining_step_matches_the_cpu_on_the_card(cuda, name):
    """One pretraining step at small widths (obs 16) on the card against
    the same step on the CPU, same weights and numpy noise, under the rules
    of chip_smoke.py's pretraining phase (``check_pretraining_step``: loss,
    metrics and norm 1e-5 of max(|value|, 1), IODINE 1e-4; gradients;
    parameters); no kernel launched."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import IODINE_CARD_TOL, PRETRAIN_TOL, check_pretraining_step, painted
    from chip_smoke import pretraining_noise

    ocr_cfg, env_cfg = _pretrain_config(name)
    obs, _ = painted(4, 16, 3, seed=1)
    reset_launches()
    found = check_pretraining_step(ocr_cfg, env_cfg, obs,
                                   pretraining_noise(ocr_cfg, env_cfg, 4,
                                                     np.random.default_rng(2)),
                                   IODINE_CARD_TOL if name == "iodine" else PRETRAIN_TOL)
    assert LAUNCHES == {} and found["grad"] <= 1.0


@pytest.mark.cuda
def test_iodine_evaluation_matches_the_cpu_on_the_card(cuda):
    """get_ari_mse.evaluate of IODINE (small widths) on the card against the
    CPU on the draws the card made: ARI within 1e-6, MSE within 1e-4
    relative; no kernel launched."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import painted
    from ocrl_tpu_torch.get_ari_mse import evaluate
    from ocrl_tpu_torch.models import create_ocr

    ocr_cfg, env_cfg = _pretrain_config("iodine")
    obs, masks = painted(8, 16, 3, seed=3)
    batches = [{"obss": obs[:4], "masks": masks[:4]}, {"obss": obs[4:], "masks": masks[4:]}]
    drawn = [{}, {}]
    reset_launches()
    got = evaluate(create_ocr(ocr_cfg, env_cfg, seed=0), batches, noise=drawn)
    assert LAUNCHES == {}
    want = evaluate(create_ocr(ocr_cfg, env_cfg, seed=0, device="cpu"), batches,
                    noise=[{"eps": d["eps"].cpu()} for d in drawn])
    assert abs(got["ari"] - want["ari"]) <= 1e-6
    assert abs(got["mse"] - want["mse"]) <= 1e-4 * abs(want["mse"])


@pytest.mark.cuda
@pytest.mark.parametrize("superbatch,whole", [(1, False), (3, False), (3, True)])
def test_prefetch_gives_the_cpu_items_on_the_card(cuda, superbatch, whole):
    from ocrl_tpu_torch.data import prefetch_to_device

    rng = np.random.default_rng(1)
    items = [{"obss": rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8),
              "masks": rng.random((n, 2, 8, 8, 1), dtype=np.float32)}
             for n in (2, 2, 2, 2, 3, 3, 1)]
    want = list(prefetch_to_device(items, "cpu", superbatch=superbatch, yield_whole=whole))
    got = list(prefetch_to_device(items, "cuda", superbatch=superbatch, yield_whole=whole))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert g[k].is_cuda and torch.equal(g[k].cpu(), w[k])


@pytest.mark.cuda
def test_train_ocr_trains_and_resumes_on_the_card(cuda, tmp_path):
    """train_ocr.main at small SLATE widths on a collected file: 8 steps
    through B1-B4 with validation and checkpoints, then resumed to 12."""
    import json

    from ocrl_tpu_torch import train_ocr
    from ocrl_tpu_torch.config import read_env_config, replace
    from ocrl_tpu_torch.data.collect import collect_dataset

    collect_dataset(replace(read_env_config("random-N5C4S4S2"), "obs_size", 16), 16, 4,
                    out_file=tmp_path / "ds.hdf5")
    argv = ["ocr=slate", "dataset=random-N5C4S4S2", f"dataset.datadir={tmp_path}/ds.hdf5",
            "dataset.obs_size=16", "ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=3",
            "ocr.slotattr.slot_size=32", "ocr.slotattr.mlp_hidden_size=32",
            "ocr.dvae.vocab_size=32", "ocr.dvae.d_model=32", "batch_size=2", "superbatch=2",
            "eval_interval=4", "log_interval=2", f"run_dir={tmp_path}/run"]
    reset_launches()
    assert train_ocr.main(argv + ["max_steps=8"])["step"] == 8
    assert LAUNCHES[tsr.BWD_KERNEL] == 3 * 8 and LAUNCHES[gumbel.IDS_KERNEL] >= 8
    assert train_ocr.main(argv + ["max_steps=12"])["step"] == 12
    records = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert sorted(r["_step"] for r in records if "train/loss" in r) == list(range(12))
    assert (tmp_path / "run" / "checkpoints" / "model_12.ckpt").exists()


@pytest.fixture
def probe_files(tmp_path):
    """A full-width SLATE checkpoint (seed 0) and a file of 128 + 8 images
    of target-N4C4S3S1 with labels and the objects' states."""
    from ocrl_tpu_torch.config import OCRConfig, read_dataset_config, read_env_config
    from ocrl_tpu_torch.data.collect import collect_dataset
    from ocrl_tpu_torch.models import create_ocr
    from ocrl_tpu_torch.utils import checkpoint as ckpt

    ckpt.save(create_ocr(OCRConfig(), read_dataset_config("target-N4C4S3S1"), seed=0),
              tmp_path, step=0)
    data = tmp_path / "probes.hdf5"
    collect_dataset(read_env_config("target-N4C4S3S1"), 128, 8, num_proc=4, with_labels=True,
                    with_states=True, out_file=data)
    return tmp_path / "checkpoints" / "model_latest.ckpt", data


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["property", "classifier", "aux"])
def test_probe_steps_match_the_cpu_on_the_card(cuda, probe_files, probe):
    """A property update at 24, a classifier step at 128 and an aux-loss
    Pooling call at 24 (B1, B2, B3) at full SLATE width, card against CPU
    on the same weights, batch and noise, under the rules of chip_smoke.py's
    probes phase (``check_property_step``, ``check_classifier_step``,
    ``check_aux_pooling``: PROBE_TOL of max(|x|, 1), matched columns
    exactly)."""
    import chip_smoke
    from ocrl_tpu_torch.data import DataLoader, H5Dataset

    encoder, data = probe_files
    batch = next(iter(DataLoader(H5Dataset(data, "TrainingSet"), 128, shuffle=True, seed=4)))
    small = {k: v[:24] for k, v in batch.items()}
    if probe == "property":
        worst = chip_smoke.check_property_step(encoder, small)
    elif probe == "classifier":
        worst = chip_smoke.check_classifier_step(encoder, batch)
    else:
        worst = chip_smoke.check_aux_pooling(encoder, small["obss"])
    assert worst <= chip_smoke.PROBE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,row0", [((3072, 4096), 3072), ((1000, 512), 24), ((7, 32), 5)])
def test_gumbel_row0_draws_rows_of_the_longer_field_on_the_card(cuda, shape, row0):
    """B1 and B2 at row0 (a data-parallel rank's rows): the field drawn is
    rows [row0, row0 + R) of the replay at row0 + R rows, within 1e-5, and
    each output its plain version's on that field."""
    from chip_smoke import FIELD_TOL, check_gumbel_row0

    gen = torch.Generator(device="cuda").manual_seed(9)
    assert check_gumbel_row0(*shape, row0, gen) <= FIELD_TOL


@pytest.mark.cuda
def test_one_nccl_rank_steps_as_one_process_on_the_card(cuda, tmp_path):
    """A small SLATE's update as the only rank of an NCCL group is bitwise
    the update in one process (chip_smoke.check_nccl_rank)."""
    from chip_smoke import check_nccl_rank, painted
    from ocrl_tpu_torch import config

    cfg = config.PolicyConfig()
    for path, value in [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
                        ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
                        ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
                        ("ocr.dvae.d_model", 32)]:
        cfg = config.replace(cfg, path, value)
    check_nccl_rank(cfg.ocr, cfg.env, painted(4, 16, 3, seed=2)[0], f"file://{tmp_path}/init")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["slate", "slotattention"])
def test_amp_convs_run_in_bf16_and_match_the_cpu_on_the_card(cuda, name):
    """``ocr.amp=bf16`` at small widths (obs 16) on the card: every conv
    block outputs bf16 while parameters, gradients and Adam's moments stay
    fp32; the broadcast decoder at obs 64 too. One step is held against the
    CPU's bf16 and fp32 steps on the same weights and draws by
    chip_smoke.check_amp_step's rule."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import check_amp_step, conv_block_dtypes, painted
    from ocrl_tpu_torch import config as tcfg
    from ocrl_tpu_torch.models import create_ocr

    for obs_size in (16, 64):
        small = ["ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=3",
                 "ocr.slotattr.slot_size=32", "ocr.slotattr.mlp_hidden_size=32",
                 "ocr.dvae.vocab_size=32", "ocr.dvae.d_model=32", "ocr.tfdec.num_dec_blocks=2",
                 "ocr.tfdec.num_dec_heads=2"]
        cfg = tcfg.compose(tcfg.TrainOCRConfig(), [f"ocr={name}", "ocr.amp=bf16"] + small).ocr
        env = tcfg.replace(tcfg.EnvConfig(), "obs_size", obs_size)
        obs, _ = painted(4, obs_size, 3, seed=3)
        ocr = create_ocr(cfg, env, seed=0)
        assert conv_block_dtypes(lambda: ocr.update(obs, None, 0)) == {torch.bfloat16}
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in ocr.module.parameters() if p.grad is not None)
        assert all(v.dtype == torch.float32 for s in ocr.optimizer.adam.state.values()
                   for k, v in s.items() if k != "step")
        found = check_amp_step(cfg, env, obs)
        assert max(found.values()) <= 1.0
