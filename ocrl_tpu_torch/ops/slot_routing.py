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

``route_sweep(k, v, q, heads)`` launches a hand-written CUDA kernel
(``csrc/slot_routing.cu``) on a CUDA tensor and raises when it cannot; on a
CPU tensor it runs ``route_sweep_reference``, the plain version, whose
gradient is autograd's. Two C entries of the same source compute it:
``slot_routing_fwd`` for one head, at most 16 slots and D a multiple of 32
up to 256 (the path of every config in configs/), and
``slot_routing_heads_fwd`` for the rest, ``sweep_supports``: 1 <= S <= 32,
H dividing D, and a ring of one token that fits the card's shared memory
(``needed_bytes``: every H <= 8 and D <= 1536 fits). Each entry computes all
three outputs itself: a persistent grid of at most one block per SM cuts
the B * N tokens into equal contiguous ranges and walks each in tiles (the
C entry chooses the tile, from the shared memory it needs, and for the
heads kernels the rest of its plan: ``heads_plan`` mirrors it, and
``card_plans`` asks the C entry); every block keeps one partial of ``S_a``
and ``A_v`` per batch row it touches, in a scratch slot that the wrapper
allocates (``scratch_rows``), and a second kernel of the same C entry sums
each row's slots in block order (no atomics: bitwise equal from run to
run). On CUDA the gradient is the
backward kernel of the same entry's pair (``slot_routing_bwd`` /
``slot_routing_heads_bwd``), as ``torch.autograd.Function``: it takes the
saved (k, v, q, a) and the cotangents, with that of ``S_a`` folded into that
of ``a`` first, and writes gk, gv and gq the same way
(ocrl_tpu/ops/slot_routing.py:142-164).

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
    """Whether the kernels take S slots of width D in ``heads`` heads: the
    single-head kernels' shapes (``fast_path``), and else 1 <= S <= 32, the
    heads dividing D, and the heads kernels' smallest ring within the card's
    shared memory (``needed_bytes``), as the C entries' rules. Everything
    with at most 8 heads and D <= 512 fits; D = 2048 at 32 slots does not."""
    return fast_path(S, D, heads) or (
        _heads_shape(S, D, heads) and needed_bytes(S, D, heads) <= SMEM_LIMIT)


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
    S = q.shape[1]
    if v.shape != k.shape:
        raise ValueError(f"route_sweep: v {tuple(v.shape)} != k {tuple(k.shape)}")
    if q.shape[0] != B or q.shape[2] != D:
        raise ValueError(f"route_sweep: q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if N < 1:
        raise ValueError("route_sweep: needs at least one token")
    if not isinstance(heads, int) or heads < 1 or D % heads:
        raise ValueError(f"route_sweep: heads={heads} must be a positive int dividing D={D}")
    if not _heads_shape(S, D, heads) and not fast_path(S, D, heads):
        raise ValueError(
            f"route_sweep: the kernels take 1 <= S <= {MAX_SLOTS} slots (got S={S}, "
            f"D={D}, heads={heads})")
    if not sweep_supports(S, D, heads):
        raise ValueError(
            f"route_sweep: S={S}, D={D}, heads={heads} needs {needed_bytes(S, D, heads)} "
            f"bytes of shared memory a block, over the card's {SMEM_LIMIT}")


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"route_sweep: {name} must be 16-byte aligned "
                             "(the kernel reads it with bulk copies)")


def _sweep_fwd(k, v, q, heads=1):
    _check_aligned(k=k, v=v, q=q)
    B, N, D = k.shape
    S = q.shape[1]
    HS = heads * S
    sms = _num_sms(k.device.index)
    a = torch.empty((B, N, HS), dtype=torch.float32, device=k.device)
    sa = torch.empty((B, HS), dtype=torch.float32, device=k.device)
    av = torch.empty((B, S, D), dtype=torch.float32, device=k.device)
    scratch = torch.empty((scratch_rows(B, N, sms), S * D + _padded(HS)),
                          dtype=torch.float32, device=k.device)
    pointers = (k.data_ptr(), v.data_ptr(), q.data_ptr(), a.data_ptr(), sa.data_ptr(),
                av.data_ptr(), scratch.data_ptr())
    if fast_path(S, D, heads):
        _build.launch_on(k.device, KERNEL, _entry(KERNEL), *pointers, B, N, S, D, sms)
    else:
        _build.launch_on(k.device, HEADS_KERNEL, _entry(HEADS_KERNEL), *pointers,
                         B, N, S, D, heads, sms)
    return sa, av, a


def _sweep_bwd(k, v, q, a, g_av, g_a, heads=1):
    _check_aligned(k=k, v=v, q=q, a=a)
    B, N, D = k.shape
    S = q.shape[1]
    sms = _num_sms(k.device.index)
    g_av, g_a = _aligned(g_av), _aligned(g_a)
    gk = torch.empty_like(k)
    gv = torch.empty_like(v)
    gq = torch.empty_like(q)
    scratch = torch.empty((scratch_rows(B, N, sms), S * D), dtype=torch.float32,
                          device=k.device)
    pointers = (k.data_ptr(), v.data_ptr(), a.data_ptr(), q.data_ptr(), g_av.data_ptr(),
                g_a.data_ptr(), gk.data_ptr(), gv.data_ptr(), gq.data_ptr(),
                scratch.data_ptr())
    if fast_path(S, D, heads):
        _build.launch_on(k.device, BWD_KERNEL, _entry(BWD_KERNEL), *pointers, B, N, S, D,
                         sms)
    else:
        _build.launch_on(k.device, HEADS_BWD_KERNEL, _entry(HEADS_BWD_KERNEL), *pointers,
                         B, N, S, D, heads, sms)
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
