"""Slot-attention routing sweep (counterpart of ocrl_tpu/ops/slot_routing.py).

One sweep over the tokens computes, for k [B, N, D] (pre-scaled by D**-0.5),
v [B, N, D] and q [B, S, D]:

    a   = softmax over slots of k q^T     [B, N, S]
    S_a = sum_n a                         [B, S]
    A_v = a^T v                           [B, S, D]

``route_sweep`` launches the hand-written CUDA kernel (``csrc/slot_routing.cu``)
on a CUDA tensor and raises when it cannot; on a CPU tensor it runs
``route_sweep_reference``, the plain version, whose gradient is autograd's.
The kernel writes ``a`` and one [S, D] partial of ``a^T v`` per chunk of
tokens; the sums over chunks and over tokens are torch reductions, as they
are jnp reductions around the TPU kernel. On CUDA the gradient is the
backward kernel of the same source, as ``torch.autograd.Function``: it takes
the saved (k, v, q, a) and the cotangents, with that of ``S_a`` folded into
that of ``a`` first, and writes gk, gv and one [S, D] partial of gq per
chunk, summed in torch (ocrl_tpu/ops/slot_routing.py:142-164).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "slot_routing_fwd"
BWD_KERNEL = "slot_routing_bwd"
CHUNK = 128        # tokens per CUDA block
MAX_SLOTS = 16
MAX_SHARED_BYTES = 232_448   # dynamic shared memory one Hopper block may use


def pick_chunk(n: int) -> int:
    """Tokens per block: ``CHUNK``, or all ``n`` tokens when fewer. The
    kernel masks a ragged last chunk, so unlike the TPU kernel it needs no
    chunk that divides ``n``."""
    return min(CHUNK, n)


def sweep_supports(S: int, D: int) -> bool:
    """Whether the kernels take S slots of width D: 1 <= S <= 16, D a
    positive multiple of 32, and (for the backward, which needs more) q,
    g_av and one chunk of dlogits in shared memory."""
    shared_bytes = (2 * S * D + CHUNK * S) * 4
    return (1 <= S <= MAX_SLOTS and D > 0 and D % 32 == 0
            and shared_bytes <= MAX_SHARED_BYTES)


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
            f"multiple of 32 (got S={q.shape[1]}, D={D})")


def route_sweep_reference(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor):
    """Plain torch sweep: the kernel's reference and its CPU path."""
    a = torch.softmax(torch.einsum("bnd,bsd->bns", k, q), dim=-1)
    return a.sum(1), torch.einsum("bns,bnd->bsd", a, v), a


_ARGTYPES = {
    KERNEL: [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    BWD_KERNEL: [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


@functools.cache
def _entry(name: str):
    return _build.entry("slot_routing", name, _ARGTYPES[name])


def _sweep_fwd(k, v, q):
    B, N, D = k.shape
    S = q.shape[1]
    chunk = pick_chunk(N)
    a = torch.empty((B, N, S), dtype=torch.float32, device=k.device)
    partial = torch.empty((B, -(-N // chunk), S, D), dtype=torch.float32,
                          device=k.device)
    _build.launch_on(k.device, KERNEL, _entry(KERNEL), k.data_ptr(), v.data_ptr(),
                     q.data_ptr(), a.data_ptr(), partial.data_ptr(), B, N, S, D, chunk)
    return a.sum(1), partial.sum(1), a


def _sweep_bwd(k, v, q, a, g_av, g_a):
    B, N, D = k.shape
    S = q.shape[1]
    chunk = pick_chunk(N)
    gk = torch.empty_like(k)
    gv = torch.empty_like(v)
    gq_partial = torch.empty((B, -(-N // chunk), S, D), dtype=torch.float32,
                             device=k.device)
    _build.launch_on(k.device, BWD_KERNEL, _entry(BWD_KERNEL), k.data_ptr(),
                     v.data_ptr(), a.data_ptr(), q.data_ptr(), g_av.data_ptr(),
                     g_a.data_ptr(), gk.data_ptr(), gv.data_ptr(),
                     gq_partial.data_ptr(), B, N, S, D, chunk)
    return gk, gv, gq_partial.sum(1)


class _RouteSweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, q):
        sa, av, a = _sweep_fwd(k, v, q)
        ctx.save_for_backward(k, v, q, a)
        return sa, av, a

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sa, g_av, g_a):
        k, v, q, a = ctx.saved_tensors
        # S_a = sum_n a is linear: its cotangent joins a's before the sweep
        g_a = (g_a + g_sa[:, None, :]).contiguous()
        return _sweep_bwd(k, v, q, a, g_av.contiguous(), g_a)


def route_sweep(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor):
    """-> (S_a [B, S], A_v [B, S, D], a [B, N, S]); see the module docstring."""
    _check(k, v, q)
    if k.device.type == "cpu":
        return route_sweep_reference(k, v, q)
    if k.device.type != "cuda":
        raise ValueError(f"route_sweep: no kernel for device {k.device}")
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad
                                    or q.requires_grad):
        return _RouteSweep.apply(k, v, q)
    return _sweep_fwd(k, v, q)     # serving: no graph, nothing saved
