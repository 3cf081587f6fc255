"""Slot-attention routing sweep (counterpart of ocrl_tpu/ops/slot_routing.py).

One sweep over the tokens computes, for k [B, N, D] (each head's columns
pre-scaled by hd**-0.5, hd = D / H), v [B, N, D] and q [B, S, D], with H
heads of hd columns each and h(c) = c // hd the head of column c:

    a[b, n, h S + s] = softmax over (h, s) of sum_{c in head h} k[b, n, c] q[b, s, c]
    S_a = sum_n a                                        [B, H S]
    A_v[b, s, c] = sum_n a[b, n, h(c) S + s] v[b, n, c]  [B, S, D]

With H = 1 these are JAX's route_sweep (ocrl_tpu/ops/slot_routing.py:123-139,
a [B, N, S]); with more heads, the sums of JAX's einsum route
(ocrl_tpu/models/slot_attention.py:97-103), which JAX runs instead of its
kernel there.

``route_sweep(k, v, q, heads)`` launches hand-written CUDA kernels
(``csrc/slot_routing.cu``) on a CUDA tensor and raises when a launch fails;
on a CPU tensor it runs ``route_sweep_reference``, the plain version, whose
gradient is autograd's. It takes every S >= 1 and every H dividing D, as
JAX's kernel takes every S and D. Three pairs of C entries of the same
source compute it, one plan each (``sweep_plan`` mirrors the choice):

- ``fast``: ``slot_routing_fwd`` / ``_bwd`` for one head, at most 16 slots
  and D a multiple of 32 up to 256 (the path of every config in configs/);
- ``heads``: ``slot_routing_heads_fwd`` / ``_bwd`` for the rest of 1 <= S
  <= 32 wherever their ring of one token fits the card's shared memory
  (``needed_bytes``: every H <= 8 and D <= 1536 fits);
- ``wide``: ``slot_routing_wide_fwd`` / ``_bwd``, the streamed plan, for
  every other shape: more slots, or wider rows.

The first two compute all three outputs in one sweep: a persistent grid of
at most one block per SM cuts the B * N tokens into equal contiguous ranges
and walks each in tiles (the C entry chooses the tile, from the shared
memory it needs, and for the heads kernels the rest of its plan:
``heads_plan`` mirrors it, and ``card_plans`` asks the C entry); every block
keeps one partial of ``S_a`` and ``A_v`` per batch row it touches, in a
scratch slot that the wrapper allocates (``scratch_rows``), and a second
kernel of the same C entry sums each row's slots in block order. The
streamed plan runs each product as its own tiled kernel, 8 x 8 outputs a
thread from slabs staged through registers into shared memory: the logits
with the softmax (dl) in their epilogue where one tile holds a token's
logits, else a row kernel; gv and gk; the token sums by segments of
tokens in a scratch the wrapper allocates, and their sum in segment order.
Its C entry chooses the tiles, the epilogue, a cut of the columns into
pieces where tokens are few, and the segments for the card's SM count;
``wide_plan`` mirrors the choice, ``wide_scratch`` sizes the scratch for
it and ``card_wide_plan`` asks the C entry. Nothing in its shared memory
grows with S or D. No plan uses atomics: bitwise equal from run to run.
On CUDA the gradient is the backward kernel of the same plan, as
``torch.autograd.Function``: it takes the saved (k, v, q, a) and the
cotangents, with that of ``S_a`` folded into that of ``a`` first, and writes
gk, gv and gq the same way (ocrl_tpu/ops/slot_routing.py:142-164).

``route_sweep`` also runs under ``torch.func``: ``vmap``, ``grad`` and
``vmap(grad(...))``, as the multi-seed policy calls it (JAX gets this from
``jax.vmap`` over its ``pallas_call``). Two ``torch.autograd.Function`` classes
carry the launches, each in the ``forward(*inputs)`` + ``setup_context``
form that ``torch.func`` requires: ``_RouteSweep`` (B3, whose backward is
``_SweepBackward``) and ``_SweepBackward`` (B4; differentiating it again
raises). Without a graph (no input requires grad, or gradients are off, as
when serving) ``_RouteSweep`` records no node and keeps nothing it saved,
so the same Function serves both. Each has a
``vmap`` rule that writes the vmapped axis out into the kernel's batch:
inputs [V, B, ...] (an unbatched one expanded to V) become [V*B, ...], one
launch, and the outputs go back to [V, B, ...] with ``out_dims`` 0; the
head count, an int, passes through unbatched. Rows of
B3 are independent, and so are rows of B4, so this is exact. The launches
themselves only ever see plain tensors (``torch.func`` unwraps them before
a Function's ``forward``), so a vmapped policy call launches B3 once per
slot iteration for all seeds. ``once_differentiable`` is not used: it wraps
``backward`` in a way ``torch.func`` cannot see through; ``_SweepBackward``
takes its place, being a Function whose own backward refuses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

KERNEL = "slot_routing_fwd"
BWD_KERNEL = "slot_routing_bwd"
HEADS_KERNEL = "slot_routing_heads_fwd"
HEADS_BWD_KERNEL = "slot_routing_heads_bwd"
HEADS_PLAN = "slot_routing_heads_plan"
WIDE_KERNEL = "slot_routing_wide_fwd"
WIDE_BWD_KERNEL = "slot_routing_wide_bwd"
WIDE_PLAN = "slot_routing_wide_plan"
FAST_SLOTS, FAST_WIDTH = 16, 256   # one head: one feature column per consumer thread
MAX_SLOTS = 32                     # the heads kernels: up to 4 blocks of 8 slots
# The heads kernels' plan (csrc/slot_routing.cu heads_plan): tiles, stages,
# slots of a logits job and of a column item, the lanes of a logits job, and
# the shared memory a block may use on Hopper
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB).
HEADS_TILES = (64, 48, 32, 24, 16, 8, 4, 2, 1)
HEADS_FWD_STAGES, HEADS_BWD_STAGES = 2, (3, 2)
SLOT_BLOCK = 8
NARROW_LANES, WIDE_LANES, NARROW_HEAD = 4, 32, 16
CONSUMERS, MAX_GROUPS = 256, 16
SMEM_LIMIT = 232448
# The streamed plan (csrc/slot_routing.cu, kWide*): slabs of WIDE_BK, two
# stages of them in shared memory, 8 x 8 outputs a thread, at least
# WIDE_MIN_THREADS threads a block; tile extents of slots and columns from
# WIDE_EXTENTS (the least ceil(n / e) (e + WIDE_TILE_COST)), of tokens from
# WIDE_TOKEN_EXTENTS, gv / gk's columns at most WIDE_TOKENS_COLS; the
# softmax / dl in the logits' epilogue at one head up to S =
# WIDE_FUSED_MAX; segments of at least WIDE_MIN_SEGMENT tokens; an SM's
# shared memory and what the system reserves of it a block.
WIDE_BK, WIDE_STAGES, WIDE_MIN_THREADS = 8, 2, 128
# registers a thread of the logits and gv / gk kernels (__maxnreg__) and of
# the token sums (__launch_bounds__ of 256 threads, 2 blocks)
WIDE_REGS, WIDE_SUMS_REGS = 168, 128
WIDE_EXTENTS, WIDE_TOKEN_EXTENTS = (16, 32, 48, 64, 96, 128), (128, 64)
WIDE_FUSED_MAX, WIDE_TILE_COST, WIDE_MIN_SEGMENT, WIDE_TOKENS_COLS = 128, 32, 64, 64
WIDE_SMEM_PER_SM, WIDE_SMEM_RESERVED = 233472, 1024


class WidePlan(NamedTuple):
    """What the streamed C entries choose for a shape (csrc: wide_plan):
    slots and columns of a head a tile, fused (1: softmax / dl in the logits
    kernel's epilogue), pieces of the head's columns and slabs a piece,
    tokens a tile of the logits and of gv / gk, columns a tile of gv / gk,
    segments of each batch row's tokens in the token sums, and the blocks an
    SM the logits, gv / gk and token-sum kernels are assumed to reach."""
    slot_extent: int
    col_extent: int
    fused: int
    pieces: int
    per: int
    pairs_tokens: int
    tokens_tokens: int
    tokens_cols: int
    segments: int
    pairs_blocks: int
    tokens_blocks: int
    sums_blocks: int


class HeadsPlan(NamedTuple):
    """What a heads C entry chooses for a shape: tokens a tile, tiles in the
    ring, lanes of a logits job (4: 4 tokens a job; 32: 8 in the forward,
    4 in the backward), floats a chunk (4 where the head width is a multiple
    of 4), column items (chunks x slot blocks, the backward's padded to 1, 2
    or 4 lanes) and their token groups: 0 is the scratch variant (items
    looped, partials added in the scratch each tile), else the registers
    variant (partials kept in registers across tiles)."""
    T: int
    stages: int
    lanes: int
    V: int
    items: int
    groups: int


def _padded(S: int) -> int:
    return -(-S // 4) * 4


def _padded8(S: int) -> int:
    return -(-S // SLOT_BLOCK) * SLOT_BLOCK


def _slot_blocks(S: int) -> int:
    return -(-S // SLOT_BLOCK)


def _lane_blocks(S: int) -> int:
    n = _slot_blocks(S)
    return 1 if n == 1 else 2 if n == 2 else 4


def _span(T: int, X: int) -> int:
    """Floats of a stage's span of T rows of X floats that may start up to 3
    floats after a 16-byte boundary (csrc: span_floats)."""
    return (T * X + 6 + 3) & ~3


def heads_fwd_bytes(S: int, D: int, H: int, T: int, stages: int = HEADS_FWD_STAGES,
                    red: int = 0) -> int:
    """Shared memory of a heads forward block (csrc: heads_fwd_smem_bytes):
    the ring of k and v, q of the row, and two [T, H, S rounded up to 8]
    logits buffers, whose region the token groups' ``red`` floats share."""
    return 128 + 4 * (stages * 2 * _span(T, D) + _padded(S * D)
                      + max(2 * T * H * _padded8(S), red))


def heads_bwd_bytes(S: int, D: int, H: int, T: int, stages: int, red: int = 0) -> int:
    """Shared memory of a heads backward block (csrc: heads_bwd_smem_bytes):
    the ring of k, v, a and g_a, g_av of the row, and four buffers of dl and
    a, whose region the token groups' ``red`` floats share."""
    return 128 + 4 * (stages * (2 * _span(T, D) + 2 * _span(T, H * S)) + _padded(S * D)
                      + max(4 * T * H * _padded8(S), red))


def heads_plan(S: int, D: int, H: int, fwd: bool = True) -> HeadsPlan | None:
    """The plan of the heads forward (or backward) C entry, as
    csrc/slot_routing.cu heads_plan chooses it, or None where it refuses the
    shape: the largest tile whose ring fits (the backward with 3 stages where
    they fit), the registers variant where its token groups' buffer fits too,
    else the scratch variant."""
    hd = D // H
    V = 4 if hd % 4 == 0 else 1
    lanes = NARROW_LANES if H * _slot_blocks(S) >= 4 or hd // V < NARROW_HEAD \
        else WIDE_LANES
    columns = V == 4 and S > 2 * SLOT_BLOCK   # the backward's column layout
    items = D // V * _slot_blocks(S) if fwd else D if columns else D // V * _lane_blocks(S)
    kept = min(CONSUMERS // items, MAX_GROUPS) if items <= CONSUMERS else 0
    per_item = SLOT_BLOCK * V + (SLOT_BLOCK if fwd else 0)
    size = heads_fwd_bytes if fwd else heads_bwd_bytes
    for T in HEADS_TILES:
        for stages in (HEADS_FWD_STAGES,) if fwd else HEADS_BWD_STAGES:
            for groups in (kept, 0):
                red = (groups - 1) * items * per_item if groups > 1 else 0
                if size(S, D, H, T, stages, red) <= SMEM_LIMIT:
                    return HeadsPlan(T, stages, lanes, V, items, groups)
    return None


# Shapes (S, H, D) whose plans between them take every tile, stage count,
# chunk width, lane count, variant and backward layout that heads_plan
# chooses over slots 1-32, heads 1-8 and widths up to 2100
# (tests/test_torch_ops.py holds the claim; tests/test_torch_cuda.py
# launches each on the card).
PLAN_SHAPES = ((1, 1, 1), (1, 1, 17), (1, 1, 68), (1, 2, 888), (1, 3, 441), (1, 4, 128),
               (1, 4, 1744), (1, 8, 200), (1, 8, 272), (1, 8, 576), (3, 8, 2096), (8, 3, 246),
               (12, 1, 2072), (16, 8, 1984), (17, 1, 64), (17, 1, 132), (17, 1, 868),
               (24, 4, 32), (24, 8, 1792), (24, 8, 1872), (25, 8, 8), (25, 8, 160))


def needed_bytes(S: int, D: int, H: int) -> int:
    """The shared memory the heads kernels need at their smallest ring (one
    token, two stages, the scratch variant): the C entries refuse a shape
    over SMEM_LIMIT and otherwise plan it (heads_plan)."""
    return max(heads_fwd_bytes(S, D, H, 1), heads_bwd_bytes(S, D, H, 1, 2))


def pick_chunk(n: int, target: int = 512) -> int:
    """Largest power-of-two chunk <= target that divides n, 0 where none from
    8 up does (ocrl_tpu/ops/slot_routing.py:54-61: JAX's sweep needs one, so
    its ``fused=always`` raises without one; the kernels here take any n)."""
    c = target
    while c >= 8:
        if n % c == 0:
            return c
        c //= 2
    return 0


def scratch_rows(B: int, N: int, max_blocks: int) -> int:
    """Rows of a launch's scratch: block g's partial of row b goes to row
    g + b, and a launch has at most ``max_blocks`` blocks and never more
    blocks than tokens."""
    return min(max_blocks, B * N) + B


def fast_path(S: int, D: int, H: int = 1) -> bool:
    """Whether the single-head kernels take the shape: one head, 1 <= S <=
    16 and D a multiple of 32 up to 256 (a tile is whole 16-byte rows and
    each consumer thread owns at most one feature column)."""
    return H == 1 and 1 <= S <= FAST_SLOTS and 0 < D <= FAST_WIDTH and D % 32 == 0


def _heads_shape(S: int, D: int, H: int) -> bool:
    return 1 <= S <= MAX_SLOTS and H >= 1 and D > 0 and D % H == 0


def sweep_supports(S: int, D: int, heads: int = 1) -> bool:
    """Whether the kernels take S slots of width D in ``heads`` heads: every
    S >= 1 with the heads dividing D (JAX's kernel takes every S and D)."""
    return S >= 1 and heads >= 1 and D > 0 and D % heads == 0


def sweep_plan(S: int, D: int, H: int = 1) -> str:
    """The pair of C entries that takes a shape ``sweep_supports`` takes:
    "fast" (``fast_path``: B3 / B4), "heads" (1 <= S <= 32 and the heads
    kernels' smallest ring within the card's shared memory, ``needed_bytes``:
    B3' / B4'), else "wide" (the streamed plan: B3'' / B4'')."""
    if fast_path(S, D, H):
        return "fast"
    if _heads_shape(S, D, H) and needed_bytes(S, D, H) <= SMEM_LIMIT:
        return "heads"
    return "wide"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wide_extent(n: int) -> int:
    """The tile extent of WIDE_EXTENTS that covers n at the least cost
    ceil(n / e) (e + WIDE_TILE_COST), the larger on a tie: 33 slots -> 48,
    64 -> 64, 65 -> 96, a head of 192 columns -> 96."""
    return min(WIDE_EXTENTS, key=lambda e: (_cdiv(n, e) * (e + WIDE_TILE_COST), -e))


def wide_threads(em: int, en: int) -> int:
    """Threads of an em x en tile: one a tile's 8 x 8 outputs, at least
    WIDE_MIN_THREADS (the others only stage slabs)."""
    return max(em * en // 64, WIDE_MIN_THREADS)


def wide_ring_bytes(em: int, en: int) -> int:
    """Shared memory of the two stages of [WIDE_BK][em + 4] and
    [WIDE_BK][en + 4]."""
    return 4 * WIDE_STAGES * WIDE_BK * (em + 4 + en + 4)


def wide_fused_bytes(em: int, en: int) -> int:
    """The logits kernel with its epilogue: the stages, or the [em, en + 4]
    tile it stages in the same memory, whichever is larger."""
    return max(wide_ring_bytes(em, en), 4 * em * (en + 4))


def wide_blocks_per_sm(threads: int, regs: int, smem: int) -> int:
    """Blocks an SM holds of a streamed kernel of ``threads`` threads,
    ``regs`` registers a thread and ``smem`` bytes."""
    return max(1, min(32, 2048 // threads, 65536 // (threads * regs),
                      WIDE_SMEM_PER_SM // (smem + WIDE_SMEM_RESERVED)))


def _fuller(blocks: int, cap: int, best: int, best_cap: int) -> bool:
    """Whether ``blocks`` on ``cap`` places fill their last wave better than
    ``best`` on ``best_cap`` (exactly, in integers)."""
    return blocks * (_cdiv(best, best_cap) * best_cap) > best * (_cdiv(blocks, cap) * cap)


def _token_extent(N: int, other: int, en: int, size, sms: int) -> tuple[int, int]:
    """(tokens a tile, blocks an SM) of a grid of other x ceil(N / te)
    blocks: the first of WIDE_TOKEN_EXTENTS whose grid fills the card's first
    wave, else the last."""
    for te in WIDE_TOKEN_EXTENTS:
        per_sm = wide_blocks_per_sm(wide_threads(te, en), WIDE_REGS, size(te, en))
        if other * _cdiv(N, te) >= per_sm * sms:
            break
    return te, per_sm


@functools.cache
def wide_plan(B: int, N: int, S: int, D: int, H: int, sms: int) -> WidePlan:
    """The plan of the streamed C entries on a card of ``sms`` SMs, as
    csrc/slot_routing.cu wide_plan chooses it (slot_routing_wide_plan reports
    it; chip_smoke.py holds the two equal):

    - tile extents: ``wide_extent`` of a head's slots and of its columns;
    - pieces: where the logits' (token tile of 128, slot tile) blocks are
      fewer than the SMs, the head's columns are cut into about SMs / blocks
      pieces of whole slabs (their partials within 4 x the size of k);
    - fused at one head where one tile holds all S logits and the columns
      are whole;
    - tokens a tile of the logits and of gv / gk: 128, or 64 where 128
      leaves the card's first wave short; columns a tile of gv / gk at most
      WIDE_TOKENS_COLS;
    - segments: the fewest whose token-sum grid fills 90 % of its last wave,
      else the fullest, each at least WIDE_MIN_SEGMENT tokens, their
      partials no larger than the rows they sum."""
    hd, HS = D // H, H * S
    se, ce = wide_extent(S), wide_extent(hd)
    slabs = _cdiv(hd, WIDE_BK)
    tiles = B * _cdiv(N, 128) * H * _cdiv(S, se)
    pieces = max(1, min(_cdiv(sms, tiles), 4 * D // HS, slabs)) if tiles < sms else 1
    per = _cdiv(slabs, pieces)
    pieces = _cdiv(slabs, per)
    fused = int(H == 1 and S <= WIDE_FUSED_MAX and pieces == 1)
    pairs_te, pairs_bps = _token_extent(N, B * H * _cdiv(S, se) * pieces, se,
                                        wide_fused_bytes if fused else wide_ring_bytes, sms)
    tokens_ce = min(ce, WIDE_TOKENS_COLS)
    tokens_te, tokens_bps = _token_extent(N, 2 * B * H * _cdiv(hd, tokens_ce), tokens_ce,
                                          wide_ring_bytes, sms)
    sums_bps = wide_blocks_per_sm(wide_threads(se, ce), WIDE_SUMS_REGS, wide_ring_bytes(se, ce))
    cap = sums_bps * sms
    sum_tiles = B * H * _cdiv(S, se) * _cdiv(hd, ce)
    most = max(1, min(_cdiv(N, WIDE_MIN_SEGMENT), N * (HS + D) // (S * D + HS)))
    segments = 1
    for g in range(1, most + 1):
        blocks = sum_tiles * g
        if 10 * blocks >= 9 * _cdiv(blocks, cap) * cap:
            segments = g
            break
        if _fuller(blocks, cap, sum_tiles * segments, cap):
            segments = g
    return WidePlan(se, ce, fused, pieces, per, pairs_te, tokens_te, tokens_ce, segments,
                    pairs_bps, tokens_bps, sums_bps)


def wide_scratch(plan: WidePlan, B: int, N: int, S: int, D: int, H: int, fwd: bool) -> int:
    """Floats of the streamed entries' scratch: the partials of the pieces
    (B N H S each) where the columns are cut, or the token sums' partials
    (B x segments rows of S D, + H S in the forward), whichever is larger."""
    parts = plan.pieces * B * N * H * S if plan.pieces > 1 else 0
    return max(parts, B * plan.segments * (S * D + (H * S if fwd else 0)))


def wide_segments(B: int, N: int, S: int, D: int, H: int, sms: int) -> int:
    """Segments of each batch row's tokens in the streamed plan's token sums
    (``wide_plan``); the scratch holds B x segments partials of S D (+ H S
    in the forward) floats."""
    return wide_plan(B, N, S, D, H, sms).segments


def _check(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor, heads: int) -> None:
    for name, t in (("k", k), ("v", v), ("q", q)):
        if t.dtype != torch.float32:
            raise TypeError(f"route_sweep: {name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"route_sweep: {name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"route_sweep: {name} must be contiguous")
        if t.device != k.device:
            raise ValueError("route_sweep: k, v and q must be on one device")
    B, N, D = k.shape
    if v.shape != k.shape:
        raise ValueError(f"route_sweep: v {tuple(v.shape)} != k {tuple(k.shape)}")
    if q.shape[0] != B or q.shape[2] != D:
        raise ValueError(f"route_sweep: q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if N < 1 or q.shape[1] < 1:
        raise ValueError("route_sweep: needs at least one token and one slot")
    if not isinstance(heads, int) or heads < 1 or D % heads:
        raise ValueError(f"route_sweep: heads={heads} must be a positive int dividing D={D}")


def route_sweep_reference(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                          heads: int = 1):
    """Plain torch sweep: the kernels' reference and its CPU path."""
    if heads == 1:
        a = torch.softmax(torch.einsum("bnd,bsd->bns", k, q), dim=-1)
        return a.sum(1), torch.einsum("bns,bnd->bsd", a, v), a
    B, N, D = k.shape
    S = q.shape[1]
    kh, vh = k.reshape(B, N, heads, D // heads), v.reshape(B, N, heads, D // heads)
    logits = torch.einsum("bnhd,bshd->bnhs", kh, q.reshape(B, S, heads, D // heads))
    a = torch.softmax(logits.reshape(B, N, heads * S), dim=-1)
    av = torch.einsum("bnhs,bnhd->bshd", a.reshape(B, N, heads, S), vh)
    return a.sum(1), av.reshape(B, S, D), a


_ARGTYPES = {   # pointers, then B, N, S, D (and H), max_blocks, then the stream
    KERNEL: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    BWD_KERNEL: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    HEADS_KERNEL: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    HEADS_BWD_KERNEL: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    HEADS_PLAN: [ctypes.c_int] * 3 + [ctypes.c_void_p],   # S, D, H, the 14 ints out
    # pointers (the backward's last the workspace), B, N, S, D, H, the SM
    # count, the scratch's floats
    WIDE_KERNEL: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                                                ctypes.c_void_p],
    WIDE_BWD_KERNEL: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                                                     ctypes.c_void_p],
    WIDE_PLAN: [ctypes.c_int] * 6 + [ctypes.c_void_p],   # B, N, S, D, H, sms, the 15 ints out
}


@functools.cache
def _entry(name: str):
    return _build.entry("slot_routing", name, _ARGTYPES[name])


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_plans(S: int, D: int, H: int, device: torch.device | None = None):
    """(forward plan, backward plan, their shared memory in bytes) that the
    heads C entries choose on ``device``'s card for S slots of width D in H
    heads (csrc: slot_routing_heads_plan); raises where they refuse it."""
    out = (ctypes.c_int * 14)()
    with torch.cuda.device(device):
        err = _entry(HEADS_PLAN)(S, D, H, ctypes.addressof(out))
    if err:
        raise ValueError(f"route_sweep: the heads kernels refuse S={S}, D={D}, heads={H}")
    return HeadsPlan(*out[:6]), HeadsPlan(*out[6:12]), out[12], out[13]


def card_wide_plan(B: int, N: int, S: int, D: int, H: int, device: torch.device | None = None):
    """(the plan the streamed C entries choose on ``device``'s card, the
    blocks an SM its occupancy calculator gives the logits, gv / gk and
    token-sum kernels at that plan's tiles) (csrc: slot_routing_wide_plan)."""
    out = (ctypes.c_int * 15)()
    with torch.cuda.device(device):
        sms = _num_sms(torch.cuda.current_device())
        err = _entry(WIDE_PLAN)(B, N, S, D, H, sms, ctypes.addressof(out))
    if err:
        raise ValueError(f"route_sweep: the streamed kernels refuse B={B}, N={N}, S={S}, "
                         f"D={D}, heads={H} (CUDA error {err})")
    return WidePlan(*out[:12]), tuple(out[12:])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"route_sweep: {name} must be 16-byte aligned "
                             "(the kernel reads it with bulk copies)")


def _sweep_fwd(k, v, q, heads=1, plan=None):
    """B3's launch on the entry pair of ``plan`` (by default
    ``sweep_plan``'s; the card checks force "wide" to hold the streamed plan
    against the others)."""
    B, N, D = k.shape
    S = q.shape[1]
    HS = heads * S
    plan = plan or sweep_plan(S, D, heads)
    sms = _num_sms(k.device.index)
    a = torch.empty((B, N, HS), dtype=torch.float32, device=k.device)
    sa = torch.empty((B, HS), dtype=torch.float32, device=k.device)
    av = torch.empty((B, S, D), dtype=torch.float32, device=k.device)
    if plan == "wide":
        floats = wide_scratch(wide_plan(B, N, S, D, heads, sms), B, N, S, D, heads, True)
        scratch = torch.empty(floats, dtype=torch.float32, device=k.device)
        _build.launch_on(k.device, WIDE_KERNEL, _entry(WIDE_KERNEL), k.data_ptr(),
                         v.data_ptr(), q.data_ptr(), a.data_ptr(), sa.data_ptr(),
                         av.data_ptr(), scratch.data_ptr(), B, N, S, D, heads, sms, floats)
        return sa, av, a
    _check_aligned(k=k, v=v, q=q)
    scratch = torch.empty((scratch_rows(B, N, sms), S * D + _padded(HS)),
                          dtype=torch.float32, device=k.device)
    pointers = (k.data_ptr(), v.data_ptr(), q.data_ptr(), a.data_ptr(), sa.data_ptr(),
                av.data_ptr(), scratch.data_ptr())
    if plan == "fast":
        _build.launch_on(k.device, KERNEL, _entry(KERNEL), *pointers, B, N, S, D, sms)
    else:
        _build.launch_on(k.device, HEADS_KERNEL, _entry(HEADS_KERNEL), *pointers,
                         B, N, S, D, heads, sms)
    return sa, av, a


def _sweep_bwd(k, v, q, a, g_av, g_a, heads=1, plan=None):
    """B4's launch, as ``_sweep_fwd``."""
    B, N, D = k.shape
    S = q.shape[1]
    plan = plan or sweep_plan(S, D, heads)
    sms = _num_sms(k.device.index)
    g_av, g_a = _aligned(g_av), _aligned(g_a)
    gk = torch.empty_like(k)
    gv = torch.empty_like(v)
    gq = torch.empty_like(q)
    pointers = (k.data_ptr(), v.data_ptr(), a.data_ptr(), q.data_ptr(), g_av.data_ptr(),
                g_a.data_ptr(), gk.data_ptr(), gv.data_ptr(), gq.data_ptr())
    if plan == "wide":
        floats = wide_scratch(wide_plan(B, N, S, D, heads, sms), B, N, S, D, heads, False)
        scratch = torch.empty(floats, dtype=torch.float32, device=k.device)
        work = torch.empty_like(a)     # dl
        _build.launch_on(k.device, WIDE_BWD_KERNEL, _entry(WIDE_BWD_KERNEL), *pointers,
                         scratch.data_ptr(), work.data_ptr(), B, N, S, D, heads, sms, floats)
        return gk, gv, gq
    _check_aligned(k=k, v=v, q=q, a=a)
    scratch = torch.empty((scratch_rows(B, N, sms), S * D), dtype=torch.float32,
                          device=k.device)
    if plan == "fast":
        _build.launch_on(k.device, BWD_KERNEL, _entry(BWD_KERNEL), *pointers,
                         scratch.data_ptr(), B, N, S, D, sms)
    else:
        _build.launch_on(k.device, HEADS_BWD_KERNEL, _entry(HEADS_BWD_KERNEL), *pointers,
                         scratch.data_ptr(), B, N, S, D, heads, sms)
    return gk, gv, gq


def _folded(info, in_dims, args) -> list[torch.Tensor]:
    """The vmapped axis of each argument moved first and folded into its
    batch axis, [V, B, ...] -> [V*B, ...]; an unbatched argument (in_dim
    None) is expanded to V copies first."""
    V = info.batch_size
    out = []
    for x, d in zip(args, in_dims):
        x = x.expand((V,) + x.shape) if d is None else x.movedim(d, 0)
        out.append(x.reshape((V * x.shape[1],) + x.shape[2:]).contiguous())
    return out


def _unfolded(V: int, outs) -> tuple:
    """[V*B, ...] -> [V, B, ...] for each output, with out_dims 0."""
    outs = tuple(o.reshape((V, o.shape[0] // V) + o.shape[1:]) for o in outs)
    return outs, (0,) * len(outs)


class _SweepBackward(torch.autograd.Function):
    """B4: (k, v, q, a, g_av, g_a, heads) -> (gk, gv, gq), g_a already
    holding the cotangent of S_a."""

    @staticmethod
    def forward(k, v, q, a, g_av, g_a, heads=1):
        return _sweep_bwd(k.contiguous(), v.contiguous(), q.contiguous(), a.contiguous(),
                          g_av, g_a, heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("route_sweep: the backward kernel is not differentiable")

    @staticmethod
    def vmap(info, in_dims, *args):
        folded = _folded(info, in_dims[:6], args[:6])
        return _unfolded(info.batch_size, _SweepBackward.apply(*folded, *args[6:]))


class _RouteSweep(torch.autograd.Function):
    """B3 recorded for autograd: its backward is B4."""

    @staticmethod
    def forward(k, v, q, heads=1):
        return _sweep_fwd(k, v, q, heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3], output[2])
        ctx.heads = inputs[3] if len(inputs) > 3 else 1

    @staticmethod
    def backward(ctx, g_sa, g_av, g_a):
        k, v, q, a = ctx.saved_tensors
        # S_a = sum_n a is linear: its cotangent joins a's before the sweep
        # (the head count, an int, gets no gradient)
        return (*_SweepBackward.apply(k, v, q, a, g_av, g_a + g_sa[:, None, :], ctx.heads),
                None)

    @staticmethod
    def vmap(info, in_dims, k, v, q, heads=1):
        folded = _folded(info, in_dims[:3], (k, v, q))
        return _unfolded(info.batch_size, _RouteSweep.apply(*folded, heads))


def route_sweep(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor, heads: int = 1):
    """-> (S_a [B, H S], A_v [B, S, D], a [B, N, H S]) for H = ``heads``; see
    the module docstring."""
    _check(k, v, q, heads)
    if k.device.type == "cpu":
        return route_sweep_reference(k, v, q, heads)
    if k.device.type != "cuda":
        raise ValueError(f"route_sweep: no kernel for device {k.device}")
    return _RouteSweep.apply(k, v, q, heads)
