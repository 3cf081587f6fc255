"""The port's routing sweep against the JAX sweep (interpret mode) and its
plain version. Tolerance 1e-5: both sides are fp32 and differ only in the
order of the sums over D and over the tokens."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.ops import slot_routing as jsr
from ocrl_tpu_torch.ops import LAUNCHES, reset_launches
from ocrl_tpu_torch.ops import gumbel as tgumbel
from ocrl_tpu_torch.ops import slot_routing as tsr
from ocrl_tpu_torch.ops import _build
from ocrl_tpu_torch.ops._build import ptxas_usage

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, N, S, D, seed):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, N, D)) * D ** -0.5).astype(np.float32)
    v = rng.standard_normal((B, N, D)).astype(np.float32)
    q = rng.standard_normal((B, S, D)).astype(np.float32)
    return k, v, q


@pytest.mark.parametrize("S", [3, 5, 6])
def test_sweep_matches_jax(S):
    B, N, D = 2, 64, 32
    k, v, q = _inputs(B, N, S, D, seed=S)
    reset_launches()
    got = tsr.route_sweep(*map(torch.from_numpy, (k, v, q)))
    assert LAUNCHES == {}          # a CPU tensor never launches the kernel
    chunk = jsr.pick_chunk(N, target=16)    # 4 chunks in the JAX kernel
    with jax.default_matmul_precision("highest"):
        kernel = jsr.route_sweep(chunk, *map(jnp.asarray, (k, v, q)))
        plain = jsr.route_sweep_reference(*map(jnp.asarray, (k, v, q)))
    for name, g, kj, pj in zip(("S_a", "A_v", "a"), got, kernel, plain):
        assert tuple(g.shape) == kj.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(kj), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(pj), err_msg=name, **TOL)


def test_sweep_ragged_n_matches_jax_reference():
    # JAX's kernel needs a chunk dividing N; 50 tokens leave a ragged chunk
    k, v, q = _inputs(2, 50, 5, 64, seed=7)
    got = tsr.route_sweep(*map(torch.from_numpy, (k, v, q)))
    with jax.default_matmul_precision("highest"):
        want = jsr.route_sweep_reference(*map(jnp.asarray, (k, v, q)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bad", ["dtype", "rank", "v_shape", "q_width", "no_slots",
                                 "width", "layout"])
def test_sweep_rejects_what_the_kernel_does_not_take(bad):
    """route_sweep refuses, before any launch, malformed inputs: another
    dtype or rank, v unlike k, q of another width, no slot, a head count that
    does not divide D, a tensor that is not contiguous. Every well-formed
    shape is taken (test_sweep_takes_what_the_heads_kernels_refused)."""
    k, v, q = (torch.from_numpy(x) for x in _inputs(2, 40, 5, 32, seed=0))
    heads = 1
    if bad == "dtype":
        k, exc = k.double(), TypeError
    elif bad == "rank":
        k, exc = k[0], ValueError
    elif bad == "v_shape":
        v, exc = v[:, :30].contiguous(), ValueError
    elif bad == "q_width":
        q, exc = torch.zeros(2, 5, 64), ValueError
    elif bad == "no_slots":
        q, exc = torch.zeros(2, 0, 32), ValueError
    elif bad == "width":        # 3 heads do not divide 32 columns
        heads, exc = 3, ValueError
    else:
        k, exc = k.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    with pytest.raises(exc):
        tsr.route_sweep(k, v, q, heads)


def definition_sweep(k, v, q, H):
    """S_a, A_v and a from their definition in float64, head by head."""
    k, v, q = (x.astype(np.float64) for x in (k, v, q))
    B, N, D = k.shape
    S, hd = q.shape[1], D // H
    logits = np.concatenate([np.einsum("bnc,bsc->bns", k[..., h * hd:(h + 1) * hd],
                                       q[..., h * hd:(h + 1) * hd]) for h in range(H)], -1)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    a = e / e.sum(-1, keepdims=True)
    av = np.concatenate([np.einsum("bns,bnc->bsc", a[..., h * S:(h + 1) * S],
                                   v[..., h * hd:(h + 1) * hd]) for h in range(H)], -1)
    return a.sum(1), av, a


@pytest.mark.parametrize("case", ["slots", "too_wide", "smem"])
def test_sweep_takes_what_the_heads_kernels_refused(case):
    """Shapes the heads kernels refuse go to the streamed plan ("wide"), and
    route_sweep takes them and matches the definition in float64 within
    1e-5 of each output's largest entry (the card checks' rule): 33 slots; D = 8192 at one head (k and v tiles and q
    over 227 KB); 32 slots of 2048 in 8 heads (303,488 bytes at one token)."""
    S, D, H = {"slots": (33, 32, 1), "too_wide": (5, 8192, 1), "smem": (32, 2048, 8)}[case]
    assert tsr.sweep_plan(S, D, H) == "wide" and tsr.sweep_supports(S, D, H)
    k, v, q = _inputs(2, 40, S, D, seed=S)
    k = (k * (D / (D // H)) ** 0.5).astype(np.float32)   # pre-scaled by (D / H)^-0.5
    got = tsr.route_sweep(*map(torch.from_numpy, (k, v, q)), H)
    for name, g, w in zip(("S_a", "A_v", "a"), got, definition_sweep(k, v, q, H)):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("D", [21, 40])
@pytest.mark.parametrize("S", [33, 64, 65])
def test_sweep_past_32_slots_matches_jax(S, D):
    """The op at one head past the heads kernels' 32 slots (the streamed
    plan's shapes) against JAX's route_sweep in interpret mode over 4
    chunks, its outputs and the VJP of all three, within 1e-5."""
    B, N = 2, 64
    assert tsr.sweep_plan(S, D) == "wide"
    k, v, q = _inputs(B, N, S, D, seed=S * 100 + D)
    rng = np.random.default_rng(S + D)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((B, S), (B, S, D), (B, N, S))]

    @jax.jit
    def jax_side(k, v, q, cots):
        want, vjp = jax.vjp(lambda *x: jsr.route_sweep(jsr.pick_chunk(N, target=16), *x),
                            k, v, q)
        return want, vjp(cots)

    with jax.default_matmul_precision("highest"):
        want, want_grads = jax_side(k, v, q, tuple(cots))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (k, v, q)]
    got = tsr.route_sweep(*leaves)
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(c) for c in cots])
    for name, g, w in zip(("S_a", "A_v", "a", "gk", "gv", "gq"), (*got, *grads),
                          (*want, *want_grads)):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), err_msg=name, **TOL)


def test_sweep_plan_mirrors_the_entries():
    """sweep_plan names the C entry pair that takes each shape: "fast" where
    fast_path holds, "heads" where the heads entries plan it (1 <= S <= 32
    and both heads plans found within the card's shared memory), "wide"
    everywhere else; and every S >= 1 with H dividing D is supported."""
    seen = set()
    for S in (1, 5, 16, 17, 32, 33, 64, 65, 200):
        for H in (1, 2, 3, 8, 16):
            for D in (H, 21 * H, 32, 96, 192, 256, 512, 1536, 2048, 2100, 4096, 8192):
                if D % H:
                    assert not tsr.sweep_supports(S, D, H)
                    continue
                assert tsr.sweep_supports(S, D, H)
                heads = S <= tsr.MAX_SLOTS and tsr.heads_plan(S, D, H, True) is not None \
                    and tsr.heads_plan(S, D, H, False) is not None
                want = "fast" if tsr.fast_path(S, D, H) else "heads" if heads else "wide"
                assert tsr.sweep_plan(S, D, H) == want, (S, D, H)
                seen.add(want)
    assert seen == {"fast", "heads", "wide"}
    assert not tsr.sweep_supports(0, 32, 1)
    assert [tsr.sweep_plan(*x) for x in ((5, 192, 1), (5, 192, 4), (24, 256, 1), (64, 192, 1),
                                         (33, 192, 1), (32, 2048, 8), (5, 8192, 1))] == \
        ["fast", "heads", "heads", "wide", "wide", "wide", "wide"]


# chip_smoke.WIDE_SHAPES [B, N, S, H, D] and corners of the streamed plan:
# one token, deep rows over few tokens, more than 128 slots, odd widths,
# many rows
WIDE_PLAN_SHAPES = [(24, 4096, 64, 1, 192), (24, 4096, 33, 1, 192), (2, 333, 32, 8, 2048),
                    (2, 40, 5, 1, 8192), (3, 37, 65, 5, 35), (24, 4096, 128, 1, 192),
                    (24, 4096, 129, 1, 192), (24, 4096, 96, 1, 192), (1, 5, 1, 1, 1),
                    (1, 1, 300, 3, 3), (64, 9000, 17, 1, 64), (2, 100, 33, 1, 192)]


@pytest.mark.parametrize("B,N,S,H,D", WIDE_PLAN_SHAPES[:5] + [(1, 5, 1, 1, 1)])
def test_wide_segments_fill_the_card(B, N, S, H, D):
    """The streamed plan's token sums: between one segment and one per
    WIDE_MIN_SEGMENT tokens (and no more partials than the rows they sum),
    the fewest whose grid fills 90 % of its last wave at the blocks an SM the
    token-sum kernel holds, else the fullest; every token in exactly one
    segment (csrc: wide_sums_kernel cuts a row into pieces of
    ceil(N / segments))."""
    from fractions import Fraction

    sms = 132
    plan = tsr.wide_plan(B, N, S, D, H, sms)
    segments = tsr.wide_segments(B, N, S, D, H, sms)
    assert segments == plan.segments
    tiles = B * H * -(-S // plan.slot_extent) * -(-(D // H) // plan.col_extent)
    cap = plan.sums_blocks * sms
    most = max(1, min(-(-N // tsr.WIDE_MIN_SEGMENT), N * (H * S + D) // (S * D + H * S)))
    assert 1 <= segments <= most

    def fill(g):
        return Fraction(tiles * g, -(-tiles * g // cap) * cap)
    if fill(segments) >= Fraction(9, 10):
        assert all(fill(g) < Fraction(9, 10) for g in range(1, segments))
    else:
        assert all(fill(g) <= fill(segments) for g in range(1, most + 1))
    seg = -(-N // segments)
    covered = [t for g in range(segments) for t in range(min(N, g * seg), min(N, g * seg + seg))]
    assert covered == list(range(N))


@pytest.mark.parametrize("B,N,S,H,D", WIDE_PLAN_SHAPES)
def test_wide_plan_mirrors_each_choice(B, N, S, H, D):
    """Each choice of the streamed plan's mirror (csrc: wide_plan): tile
    extents at the least cost; the head's columns cut into pieces of whole
    slabs only where the logits' blocks are fewer than the SMs, their
    partials within 4 x the size of k; the softmax / dl in the logits'
    epilogue exactly at one head, S <= WIDE_FUSED_MAX and uncut columns;
    128 tokens a tile unless that leaves the first wave short; gv / gk's
    columns at most WIDE_TOKENS_COLS; the blocks an SM each kernel holds at
    its registers and shared memory; a scratch for the partials."""
    sms, hd = 132, D // H
    plan = tsr.wide_plan(B, N, S, D, H, sms)

    def cost(n, e):
        return (-(-n // e) * (e + tsr.WIDE_TILE_COST), -e)
    assert plan.slot_extent == min(tsr.WIDE_EXTENTS, key=lambda e: cost(S, e))
    assert plan.col_extent == min(tsr.WIDE_EXTENTS, key=lambda e: cost(hd, e))
    se, ce = plan.slot_extent, plan.col_extent
    slabs = -(-hd // tsr.WIDE_BK)
    assert (plan.pieces - 1) * plan.per < slabs <= plan.pieces * plan.per
    if plan.pieces > 1:
        assert B * -(-N // 128) * H * -(-S // se) < sms
        assert plan.pieces * B * N * H * S <= 4 * B * N * D
    assert plan.fused == int(H == 1 and S <= tsr.WIDE_FUSED_MAX and plan.pieces == 1)
    assert plan.tokens_cols == min(ce, tsr.WIDE_TOKENS_COLS)
    for te, other, en, size, blocks in (
            (plan.pairs_tokens, B * H * -(-S // se) * plan.pieces, se,
             tsr.wide_fused_bytes if plan.fused else tsr.wide_ring_bytes, plan.pairs_blocks),
            (plan.tokens_tokens, 2 * B * H * -(-hd // plan.tokens_cols), plan.tokens_cols,
             tsr.wide_ring_bytes, plan.tokens_blocks)):
        assert blocks == tsr.wide_blocks_per_sm(tsr.wide_threads(te, en), tsr.WIDE_REGS,
                                                size(te, en))
        per_128 = tsr.wide_blocks_per_sm(tsr.wide_threads(128, en), tsr.WIDE_REGS,
                                         size(128, en))
        assert te == (128 if other * -(-N // 128) >= per_128 * sms else 64)
        assert tsr.wide_threads(te, en) >= max(te * en // 64, te, en)   # every run staged
    assert plan.sums_blocks == tsr.wide_blocks_per_sm(
        tsr.wide_threads(se, ce), tsr.WIDE_SUMS_REGS, tsr.wide_ring_bytes(se, ce))
    for fwd in (True, False):
        floats = tsr.wide_scratch(plan, B, N, S, D, H, fwd)
        assert floats >= B * plan.segments * (S * D + (H * S if fwd else 0))
        assert floats >= (plan.pieces * B * N * H * S if plan.pieces > 1 else 0)


def test_wide_plan_mirror_matches_the_c_plan(tmp_path):
    """The streamed plan's host code, cut from csrc/slot_routing.cu and built
    with the host's C++ compiler, chooses what ``wide_plan`` and
    ``wide_scratch`` mirror at WIDE_PLAN_SHAPES and 400 shapes drawn from a
    seed, on cards of 132, 114, 78, 8 and 1 SMs."""
    import shutil
    import subprocess

    text = (Path(tsr.__file__).parent / "csrc" / "slot_routing.cu").read_text()
    start = text.index("constexpr int kWideBK")
    end = text.index("__device__ __forceinline__ bool aligned16", start)
    source = tmp_path / "plan.cpp"
    source.write_text(
        "#include <cstdio>\n#define __host__\n#define __device__\n" + text[start:end] +
        "int main() {\n  int B, N, S, D, H, sms;\n"
        "  while (std::scanf(\"%d %d %d %d %d %d\", &B, &N, &S, &D, &H, &sms) == 6) {\n"
        "    const WidePlan p = wide_plan(B, N, S, D, H, sms);\n"
        "    std::printf(\"%d %d %d %d %d %d %d %d %d %d %d %d %lld %lld\\n\", p.se, p.ce, "
        "p.fused, p.pieces, p.per, p.pairs_te, p.tokens_te, p.tokens_ce, p.segments, "
        "p.pairs_bps, p.tokens_bps, p.sums_bps, p.scratch_fwd, p.scratch_bwd);\n  }\n}\n")
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler is needed (the native rasterizer is built with it too)"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(tmp_path / "plan"), str(source)],
                   check=True)
    rng = np.random.default_rng(22)
    shapes = [(B, N, S, D, H, sms) for B, N, S, H, D in WIDE_PLAN_SHAPES
              for sms in (132, 114, 78, 8, 1)]
    for _ in range(400):
        H = int(rng.choice([1, 1, 2, 3, 4, 5, 8]))
        shapes.append((int(rng.integers(1, 65)), int(rng.choice([1, 7, 40, 333, 4096,
                                                                 int(rng.integers(1, 9000))])),
                       int(rng.integers(1, 301)), H * int(rng.integers(1, 401)), H,
                       int(rng.choice([132, 114, 78, 8, 1]))))
    out = subprocess.run([str(tmp_path / "plan")], input="\n".join(
        " ".join(map(str, s)) for s in shapes), capture_output=True, text=True,
        check=True).stdout.split("\n")
    for shape, line in zip(shapes, out):
        B, N, S, D, H, sms = shape
        plan = tsr.wide_plan(B, N, S, D, H, sms)
        mirrored = [*plan, tsr.wide_scratch(plan, B, N, S, D, H, True),
                    tsr.wide_scratch(plan, B, N, S, D, H, False)]
        assert [int(x) for x in line.split()] == mirrored, shape


def block_range(g: int, G: int, BN: int) -> tuple[int, int]:
    """Block g's range [start, end) of the B * N token stream, as
    csrc/slot_routing.cu's block_tiles cuts it."""
    return g * BN // G, (g + 1) * BN // G


def row_blocks(b: int, N: int, G: int, BN: int) -> range:
    """The blocks whose ranges meet batch row b, as csrc/slot_routing.cu's
    reduce_rows finds them (the block holding token t is ((t + 1) G - 1) //
    BN) and in the order it sums their scratch slots g + b."""
    def holding(t):
        return ((t + 1) * G - 1) // BN
    return range(holding(b * N), holding(b * N + N - 1) + 1)


# the tiles the C entries may choose (csrc/slot_routing.cu kFwdTiles,
# kBwdTiles, kHeadsTiles)
_TILES = tsr.HEADS_TILES


@pytest.mark.parametrize("B,N,num_sms", [(24, 4096, 132), (16, 4096, 132),
                                         (64, 4096, 132), (3, 333, 132),
                                         (2, 100, 132), (1, 5, 132), (7, 50, 4)])
def test_plan_covers_any_n(B, N, num_sms):
    """The kernels' grid: one block per SM, or one per tile of a small
    input, whatever tile the C entry chooses; the block ranges cut the
    B * N tokens into contiguous pieces that differ by at most one token;
    row_blocks(b) lists exactly the blocks whose ranges meet row b, in order,
    so each row's partials are summed in one order; and every slot g + b
    they write lies in the scratch the wrapper allocates."""
    BN = B * N
    rows = tsr.scratch_rows(B, N, num_sms)
    for T in _TILES:
        G = min(num_sms, -(-BN // T))
        ranges = [block_range(g, G, BN) for g in range(G)]
        assert ranges[0][0] == 0 and ranges[-1][1] == BN
        assert all(e == s for (_, e), (s, _) in zip(ranges, ranges[1:]))
        sizes = [e - s for s, e in ranges]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        for b in range(B):
            meet = [g for g, (s, e) in enumerate(ranges) if s < (b + 1) * N and e > b * N]
            assert list(row_blocks(b, N, G, BN)) == meet
            assert all(0 <= g + b < rows for g in meet)


def heads_plan(S: int, D: int, H: int):
    """(tile, stages) of the heads forward and of the heads backward that
    the C entries choose (csrc/slot_routing.cu heads_plan, mirrored by
    ops.slot_routing.heads_plan)."""
    f, b = tsr.heads_plan(S, D, H, True), tsr.heads_plan(S, D, H, False)
    return (f.T, f.stages), (b.T, b.stages)


def test_sweep_supports_and_tiles():
    """The single-head kernels take 1 <= S <= 16 and D a multiple of 32 up
    to 256 (fast_path); the heads kernels take the rest of 1 <= S <= 32 with
    H dividing D where their smallest ring fits a Hopper block's shared
    memory: everywhere with H <= 8 and D <= 1536 (each C entry then chooses
    a tile that fits: the card-only tests launch every S at the narrowest
    and widest D, H up to 8 at D = 21, 100 and 512, and every plan of
    PLAN_SHAPES); the streamed plan takes the rest (sweep_plan). Each plan is the largest tile whose ring fits (the
    backward with 3 stages where they fit), in the registers variant where
    the column items fill at most 256 threads and their token groups' buffer
    fits too."""
    for S in range(0, 35):
        for H in (1, 2, 3, 4, 8, 16):
            for D in range(1, 600, 1 if S in (1, 17, 32) else 7):
                fast = H == 1 and 1 <= S <= 16 and D % 32 == 0 and D <= 256
                heads = 1 <= S <= 32 and D % H == 0
                assert tsr.fast_path(S, D, H) == fast, (S, D, H)
                assert tsr.sweep_supports(S, D, H) == (S >= 1 and D % H == 0), (S, D, H)
                # 33 slots, or a ring of one token over shared memory: streamed
                fits = heads and tsr.needed_bytes(S, D, H) <= tsr.SMEM_LIMIT
                want = "fast" if fast else "heads" if fits else "wide"
                assert fits or not heads or H > 8, (S, D, H)   # H <= 8, D < 600 fit
                if tsr.sweep_supports(S, D, H):
                    assert tsr.sweep_plan(S, D, H) == want, (S, D, H)
    for S, D, H, fits in [(32, 512, 8, True), (32, 1536, 8, True), (32, 2048, 8, False),
                          (16, 1024, 8, True), (16, 4096, 8, False), (5, 4096, 1, True),
                          (5, 8192, 1, False), (1, 4096, 64, True)]:
        assert tsr.sweep_supports(S, D, H), (S, D, H)     # the streamed plan takes the rest
        assert (tsr.sweep_plan(S, D, H) == "heads") == fits, (S, D, H)
        assert (tsr.needed_bytes(S, D, H) <= tsr.SMEM_LIMIT) == fits, (S, D, H)
    # the tiles the C entries choose where they have room, and at the corner
    assert heads_plan(5, 192, 4) == ((64, 2), (48, 2))
    assert heads_plan(24, 256, 1) == ((48, 2), (32, 2))
    assert heads_plan(7, 100, 1) == ((64, 2), (64, 3))
    assert heads_plan(32, 512, 8) == ((16, 2), (8, 2))
    # and the rest of each plan: lanes of a logits job, floats of a chunk,
    # column items and token groups (0: the scratch variant)
    P = tsr.HeadsPlan
    assert tsr.heads_plan(5, 192, 4) == P(64, 2, 4, 4, 48, 5)
    assert tsr.heads_plan(24, 256, 1, False) == P(32, 2, 32, 4, 256, 1)   # one column a thread
    assert tsr.heads_plan(7, 100, 1) == P(64, 2, 32, 4, 25, 10)
    assert tsr.heads_plan(32, 512, 8) == P(16, 2, 4, 4, 512, 0)
    assert tsr.heads_plan(5, 21, 3, False) == P(64, 3, 4, 1, 21, 12)
    for S, D, H in [(5, 192, 4), (24, 256, 1), (32, 512, 8), (5, 21, 3), (1, 4, 1)]:
        for fwd, size in ((True, tsr.heads_fwd_bytes), (False, tsr.heads_bwd_bytes)):
            p = tsr.heads_plan(S, D, H, fwd)
            red = (p.groups - 1) * p.items * (8 * p.V + 8 * fwd) if p.groups > 1 else 0
            assert size(S, D, H, p.T, p.stages, red) <= tsr.SMEM_LIMIT
            bigger = [T for T in tsr.HEADS_TILES if T > p.T]
            assert all(size(S, D, H, T, 2) > tsr.SMEM_LIMIT for T in bigger), (S, D, H)
            assert 1 <= p.groups <= 16 if p.items <= 256 else p.groups == 0
    assert tsr.needed_bytes(32, 2048, 8) == 303488      # past the heads kernels: streamed
    sa, _, _ = tsr.route_sweep(torch.zeros(1, 3, 2048), torch.zeros(1, 3, 2048),
                               torch.zeros(1, 32, 2048), 8)
    torch.testing.assert_close(sa, torch.full((1, 256), 3 / 256))
    k, v, q = torch.zeros(1, 3, 512), torch.zeros(1, 3, 512), torch.zeros(1, 32, 512)
    sa, av, a = tsr.route_sweep(k, v, q, 8)    # the corner of the range, on the CPU
    assert sa.shape == (1, 256) and av.shape == (1, 32, 512) and a.shape == (1, 3, 256)
    torch.testing.assert_close(sa, torch.full((1, 256), 3 / 256))


def first_design_bytes(S: int, D: int, H: int) -> int:
    """The shared memory the first heads kernels needed at their
    smallest ring, kept as the record of the shapes they took: one token,
    two stages, q and g_av of the row both in shared memory, logits at S
    rounded up to 4."""
    def span(T, X):
        return (T * X + 9) & ~3

    def pad4(x):
        return -(-x // 4) * 4
    HSP = H * pad4(S)
    fwd = 128 + 4 * (2 * 2 * span(1, D) + pad4(S * D) + 2 * HSP)
    bwd = 128 + 4 * (2 * (2 * span(1, D) + 2 * span(1, H * S)) + 2 * pad4(S * D) + 4 * HSP)
    return max(fwd, bwd)


def test_heads_kernels_take_every_shape_the_first_design_took():
    """No shape the first heads kernels took is refused now: every S up to
    32, H dividing D, at every D up to the largest the first design fitted
    (each H of 1-8, 12, 16, 64, all D at its edge), and every H <= 8, S <=
    32, D <= 512."""
    for S in range(1, 33):
        for H in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 64):
            D = H
            while first_design_bytes(S, D + H, H) <= tsr.SMEM_LIMIT:
                D += H
            edge = range(max(H, D - 8 * H), D + 1, H)
            for d in (*range(H, D + 1, H * 37), *edge):
                assert first_design_bytes(S, d, H) <= tsr.SMEM_LIMIT
                assert tsr.sweep_plan(S, d, H) != "wide", (S, d, H)
                assert tsr.heads_plan(S, d, H, True) and tsr.heads_plan(S, d, H, False)
            if H <= 8:
                for d in range(H, 513, H):
                    assert tsr.sweep_plan(S, d, H) != "wide", (S, d, H)


def test_plan_shapes_cover_every_choice_of_the_plan():
    """PLAN_SHAPES, which the card-only tests launch, take between them every
    forward tile, backward (tile, stages), and (chunk floats, lanes,
    variant) of each kernel that the plan chooses over S in 1-32, H in
    1-8 and D up to 2100 (the variant: scratch, registers with one token
    group, registers with more; the backward's layout too: slot blocks, or
    past 16 slots at V = 4 one column with all its slots a thread)."""
    def choices(S, D, H):
        f, b = tsr.heads_plan(S, D, H, True), tsr.heads_plan(S, D, H, False)
        kind = [("scratch", "one", "groups")[min(p.groups, 2)] for p in (f, b)]
        layout = "columns" if b.V == 4 and S > 2 * tsr.SLOT_BLOCK else "slot blocks"
        return {("fwd", f.V, f.lanes, kind[0]), ("bwd", b.V, b.lanes, kind[1], layout),
                ("fwd", f.T, f.stages), ("bwd", b.T, b.stages)}

    every = set()
    for S in (1, 3, 5, 8, 9, 12, 16, 17, 24, 25, 32):
        for H in (1, 2, 3, 4, 8):
            for D in range(H, 2100, H):
                if tsr.sweep_plan(S, D, H) == "heads" and D % H == 0:
                    every |= choices(S, D, H)
    covered = set().union(*(choices(S, D, H) for S, H, D in tsr.PLAN_SHAPES))
    assert covered == every, every - covered
    assert {k[1] for k in every if k[0] == "fwd" and len(k) == 3} == set(tsr.HEADS_TILES)


_CTYPE_OF = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}


def _c_signatures(source: str) -> dict[str, list[str]]:
    """extern "C" functions of a .cu source: name -> kind of each parameter
    (ptr, int, long long or float)."""
    text = (Path(tsr.__file__).parent / "csrc" / source).read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for p in params.split(","):
            p = p.strip()
            kinds.append("ptr" if "*" in p else "float" if p.startswith("float")
                         else "long long" if p.startswith("long long") else "int")
        out[name] = kinds
    return out


@pytest.mark.parametrize("module,source,name", [
    (tsr, "slot_routing.cu", tsr.KERNEL), (tsr, "slot_routing.cu", tsr.BWD_KERNEL),
    (tsr, "slot_routing.cu", tsr.HEADS_KERNEL), (tsr, "slot_routing.cu", tsr.HEADS_BWD_KERNEL),
    (tsr, "slot_routing.cu", tsr.HEADS_PLAN), (tsr, "slot_routing.cu", tsr.WIDE_KERNEL),
    (tsr, "slot_routing.cu", tsr.WIDE_BWD_KERNEL), (tsr, "slot_routing.cu", tsr.WIDE_PLAN),
    (tgumbel, "gumbel.cu", tgumbel.SOFT_KERNEL), (tgumbel, "gumbel.cu", tgumbel.IDS_KERNEL)])
def test_ctypes_argtypes_match_the_c_signatures(module, source, name):
    """A wrong ctypes argtype shows only on the card (a pointer cut to 32
    bits, an int read as a pointer): hold each wrapper's _ARGTYPES against
    the extern "C" signature in its source, in count and kind."""
    kinds = _c_signatures(source)[name]
    assert module._ARGTYPES[name] == [_CTYPE_OF[k] for k in kinds]


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116sweep_bwd_kernelILi11EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116sweep_bwd_kernelILi11EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111reduce_rowsEPKfPfS2_iiixi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111reduce_rowsEPKfPfS2_iiixi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 400 bytes cmem[0]
"""
    assert ptxas_usage(log) == {
        "sweep_bwd_kernel<11>": {"registers": 255, "spill_stores": 8, "spill_loads": 12},
        "reduce_rows": {"registers": 18, "spill_stores": 0, "spill_loads": 0}}


@pytest.mark.parametrize("name", ["slot_routing", "gumbel"])
def test_ptxas_report_is_kept_beside_the_library(name, tmp_path, monkeypatch):
    """The spill check reads each library's ptxas report from beside it, so
    a library built by an earlier run is checked too; a library without its
    report counts as not built, and build_log raises without one."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib, log = _build.library_path(name), _build.log_path(name)
    assert log.parent == lib.parent == tmp_path and log.name.startswith(lib.stem)
    with pytest.raises(RuntimeError):
        _build.build_log(name)
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("would compile")))
    with pytest.raises(RuntimeError, match="would compile"):
        _build.build([name])                # the library alone is not enough
    log.write_text("ptxas info    : Used 8 registers")
    assert _build.build([name]) == {}       # both there: nothing to compile
    assert _build.build_log(name) == "ptxas info    : Used 8 registers"
    assert name in _build.sources()


@pytest.mark.parametrize("S", [3, 5])
def test_sweep_gradient_matches_jax(S):
    """The port's sweep gradient off the card (autograd of the plain sweep,
    B4's plain version) against jax.grad of the JAX sweep, whose custom VJP
    runs the Pallas backward kernel in interpret mode over 4 chunks. All
    three outputs carry a cotangent, as tests/test_ops.py:99-127 does."""
    B, N, D = 2, 64, 32
    k, v, q = _inputs(B, N, S, D, seed=10 + S)
    rng = np.random.default_rng(20 + S)
    t_sa = rng.standard_normal((B, S)).astype(np.float32)
    t_av = rng.standard_normal((B, S, D)).astype(np.float32)
    t_a = rng.standard_normal((B, N, S)).astype(np.float32)

    def jloss(k, v, q):
        sa, av, a = jsr.route_sweep(jsr.pick_chunk(N, target=16), k, v, q)
        return (jnp.sum(sa * t_sa) + jnp.sum(jnp.tanh(av) * t_av)
                + jnp.sum(jnp.tanh(a) * t_a))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (k, v, q)))
    tk, tv, tq = (torch.from_numpy(x).requires_grad_() for x in (k, v, q))
    sa, av, a = tsr.route_sweep(tk, tv, tq)
    loss = ((sa * torch.from_numpy(t_sa)).sum()
            + (torch.tanh(av) * torch.from_numpy(t_av)).sum()
            + (torch.tanh(a) * torch.from_numpy(t_a)).sum())
    got = torch.autograd.grad(loss, (tk, tv, tq))
    for name, g, w in zip(("gk", "gv", "gq"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   rtol=1e-5, atol=1e-5)
