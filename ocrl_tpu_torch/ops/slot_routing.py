"""Slot-attention routing sweep (counterpart of ocrl_tpu/ops/slot_routing.py).

One sweep over the tokens computes, for k [B, N, D] (pre-scaled by D**-0.5),
v [B, N, D] and q [B, S, D]:

    a   = softmax over slots of k q^T     [B, N, S]
    S_a = sum_n a                         [B, S]
    A_v = a^T v                           [B, S, D]

``route_sweep`` launches the hand-written CUDA kernel (``csrc/slot_routing.cu``)
on a CUDA tensor and raises when it cannot; on a CPU tensor it runs
``route_sweep_reference``, the plain version, whose gradient is autograd's.
The kernel computes all three outputs itself: a persistent grid of at most
one block per SM cuts the B * N tokens into equal contiguous ranges and
walks each in tiles (the C entry chooses the tile, from the shared memory it
needs); every block keeps one partial of ``S_a`` and ``a^T v`` per batch row
it touches, in a scratch slot that the wrapper allocates
(``scratch_rows``), and a second kernel of the same C entry sums each row's
slots in block order (no atomics: bitwise equal from run to run). On CUDA
the gradient is the backward kernel of the same source, as
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
launch, and the outputs go back to [V, B, ...] with ``out_dims`` 0. Rows of
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

import torch

from . import _build

KERNEL = "slot_routing_fwd"
BWD_KERNEL = "slot_routing_bwd"
MAX_SLOTS = 16
MAX_WIDTH = 256        # one feature column per consumer thread


def _padded(S: int) -> int:
    return -(-S // 4) * 4


def scratch_rows(B: int, N: int, max_blocks: int) -> int:
    """Rows of a launch's scratch: block g's partial of row b goes to row
    g + b, and a launch has at most ``max_blocks`` blocks and never more
    blocks than tokens."""
    return min(max_blocks, B * N) + B


def sweep_supports(S: int, D: int) -> bool:
    """Whether the kernels take S slots of width D: 1 <= S <= 16 and D a
    multiple of 32 up to 256, so that a tile is whole 16-byte rows and each
    consumer thread owns at most one feature column."""
    return 1 <= S <= MAX_SLOTS and 0 < D <= MAX_WIDTH and D % 32 == 0


def _check(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor) -> None:
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
    if N < 1:
        raise ValueError("route_sweep: needs at least one token")
    if not sweep_supports(q.shape[1], D):
        raise ValueError(
            f"route_sweep: the kernel takes 1 <= S <= {MAX_SLOTS} slots and D a "
            f"multiple of 32 up to {MAX_WIDTH} (got S={q.shape[1]}, D={D})")


def route_sweep_reference(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor):
    """Plain torch sweep: the kernel's reference and its CPU path."""
    a = torch.softmax(torch.einsum("bnd,bsd->bns", k, q), dim=-1)
    return a.sum(1), torch.einsum("bns,bnd->bsd", a, v), a


_ARGTYPES = {   # pointers, then B, N, S, D, max_blocks, then the stream
    KERNEL: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    BWD_KERNEL: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


@functools.cache
def _entry(name: str):
    return _build.entry("slot_routing", name, _ARGTYPES[name])


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"route_sweep: {name} must be 16-byte aligned "
                             "(the kernel reads it with bulk copies)")


def _sweep_fwd(k, v, q):
    _check_aligned(k=k, v=v, q=q)
    B, N, D = k.shape
    S = q.shape[1]
    sms = _num_sms(k.device.index)
    a = torch.empty((B, N, S), dtype=torch.float32, device=k.device)
    sa = torch.empty((B, S), dtype=torch.float32, device=k.device)
    av = torch.empty((B, S, D), dtype=torch.float32, device=k.device)
    scratch = torch.empty((scratch_rows(B, N, sms), S * D + _padded(S)),
                          dtype=torch.float32, device=k.device)
    _build.launch_on(k.device, KERNEL, _entry(KERNEL), k.data_ptr(), v.data_ptr(),
                     q.data_ptr(), a.data_ptr(), sa.data_ptr(), av.data_ptr(),
                     scratch.data_ptr(), B, N, S, D, sms)
    return sa, av, a


def _sweep_bwd(k, v, q, a, g_av, g_a):
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
    _build.launch_on(k.device, BWD_KERNEL, _entry(BWD_KERNEL), k.data_ptr(),
                     v.data_ptr(), a.data_ptr(), q.data_ptr(), g_av.data_ptr(),
                     g_a.data_ptr(), gk.data_ptr(), gv.data_ptr(), gq.data_ptr(),
                     scratch.data_ptr(), B, N, S, D, sms)
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
    """B4: (k, v, q, a, g_av, g_a) -> (gk, gv, gq), g_a already holding the
    cotangent of S_a."""

    @staticmethod
    def forward(k, v, q, a, g_av, g_a):
        return _sweep_bwd(k.contiguous(), v.contiguous(), q.contiguous(), a.contiguous(),
                          g_av, g_a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("route_sweep: the backward kernel is not differentiable")

    @staticmethod
    def vmap(info, in_dims, *args):
        return _unfolded(info.batch_size, _SweepBackward.apply(*_folded(info, in_dims, args)))


class _RouteSweep(torch.autograd.Function):
    """B3 recorded for autograd: its backward is B4."""

    @staticmethod
    def forward(k, v, q):
        return _sweep_fwd(k, v, q)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output[2])

    @staticmethod
    def backward(ctx, g_sa, g_av, g_a):
        k, v, q, a = ctx.saved_tensors
        # S_a = sum_n a is linear: its cotangent joins a's before the sweep
        return _SweepBackward.apply(k, v, q, a, g_av, g_a + g_sa[:, None, :])

    @staticmethod
    def vmap(info, in_dims, k, v, q):
        return _unfolded(info.batch_size, _RouteSweep.apply(*_folded(info, in_dims, (k, v, q))))


def route_sweep(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor):
    """-> (S_a [B, S], A_v [B, S, D], a [B, N, S]); see the module docstring."""
    _check(k, v, q)
    if k.device.type == "cpu":
        return route_sweep_reference(k, v, q)
    if k.device.type != "cuda":
        raise ValueError(f"route_sweep: no kernel for device {k.device}")
    return _RouteSweep.apply(k, v, q)
