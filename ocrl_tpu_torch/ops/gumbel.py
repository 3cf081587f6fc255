"""Gumbel sampling over rows of logits (counterpart of ocrl_tpu/ops/gumbel.py).

For logits [R, V] and a Gumbel field g [R, V], g = -log(E + tiny) with E
standard exponential:

    gumbel_softmax_sample:  y   = softmax((logits + g) / tau)   [R, V]
    gumbel_argmax_ids:      ids = argmax(logits + g)            [R] int64

On a CUDA tensor each launches its hand-written kernel (``csrc/gumbel.cu``),
which draws g itself from a counter-based Philox keyed by a seed that the
wrapper draws from ``generator`` into device memory (no host sync), or raises
when it cannot; on a CPU tensor each runs its plain version, drawing g with
``generator``. ``noise=g`` makes either read the given field instead of
drawing one; ``g_out`` (a tensor like the logits) receives the field that was
used. The soft sample is differentiable in the logits, with the backward of
ocrl_tpu/ops/gumbel.py::_soft_bwd in plain torch; the ids take no gradient.

``row0`` places the R rows in a larger field, at rows row0 .. row0 + R - 1:
a data-parallel rank whose logits are rows row0 .. of the global batch's
draws its rows of the field that one process would draw for the whole
batch. The kernels add it to the Philox counter's row word, and draw
nothing more. The plain version draws ``gumbel_field`` at row0 + R rows and
keeps the last R: its plain twin, which advances the generator by the
longer draw, so a sharded OCR on the CPU draws its fields whole instead
(``models.common.gumbel_draw`` decides how a call site draws).

``replay_field`` recomputes in numpy, from the seed, the field a kernel drew:
the plain reference of the kernels' noise, for the tests and chip_smoke.py,
never on the main path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

SOFT_KERNEL = "gumbel_soft"
IDS_KERNEL = "gumbel_ids"
MAX_V = 8192          # 256 threads x 8 float4 per thread hold one row
TINY = torch.finfo(torch.float32).tiny
# Added to the high word of the Philox key, one stream per kernel, as
# csrc/gumbel.cu keys them (kIdsStream there).
SOFT_STREAM, IDS_STREAM = 0, 0x5E3779B9
_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))
_LOW32, _SHIFT32 = np.uint64(0xFFFFFFFF), np.uint64(32)


def gumbel_field(shape, generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """A Gumbel field drawn in torch: -log(E + tiny), E ~ Exp(1), as the
    JAX package draws it off the TPU."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(generator=generator) + TINY)


def philox4x32_10(counter: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Philox4x32-10 (Salmon et al., SC'11) in numpy, with the round and key
    schedule of csrc/gumbel.cu: uint32 words, counter [..., 4] and key
    [..., 2] -> [..., 4]. A product of two uint32 is exact in uint64, so
    ``__umulhi(a, b)`` is ``(a * b) >> 32``."""
    c = [np.asarray(counter[..., i], np.uint64) for i in range(4)]
    k = [np.asarray(key[..., i], np.uint64) for i in range(2)]
    for r in range(10):
        if r:
            k = [(k[0] + _PHILOX_W[0]) & _LOW32, (k[1] + _PHILOX_W[1]) & _LOW32]
        p0, p1 = _PHILOX_M[0] * c[0], _PHILOX_M[1] * c[2]
        c = [(p1 >> _SHIFT32) ^ c[1] ^ k[0], p1 & _LOW32,
             (p0 >> _SHIFT32) ^ c[3] ^ k[1], p0 & _LOW32]
    return np.stack(c, axis=-1).astype(np.uint32)


def gumbel_of_bits(bits: np.ndarray) -> np.ndarray:
    """g = -log(-log(u) + tiny) in float64, u = (2m + 1) 2^-24 from the top
    23 bits m of each uint32 word: u runs from 2^-24 to 1 - 2^-24, so g from
    -2.81155 to 16.63553."""
    m = (np.asarray(bits, np.uint32) >> np.uint32(9)).astype(np.float64)
    u = (2.0 * m + 1.0) * 2.0 ** -24
    return -np.log(-np.log(u) + TINY)


def replay_field(seed: int, stream: int, rows: int, V: int, row0: int = 0) -> np.ndarray:
    """The field g [rows, V] that a kernel draws from ``seed`` (the int64 the
    wrapper drew) on ``stream`` (``SOFT_STREAM`` or ``IDS_STREAM``) at
    ``row0``, replayed exactly in numpy, in float64: Philox4x32-10 keyed by
    (low word of the seed, high word + stream) and counted by (column / 4,
    row0 + row, 0, 0); word i of a call is column 4 (column / 4) + i. Only
    V % 4 == 0, as the kernels."""
    s = int(seed) % 2 ** 64
    key = np.array([s & 0xFFFFFFFF, ((s >> 32) + stream) & 0xFFFFFFFF], np.uint32)
    col4, row = np.meshgrid(np.arange(V // 4, dtype=np.uint32),
                            np.arange(row0, row0 + rows, dtype=np.uint32))
    zero = np.zeros_like(col4)
    words = philox4x32_10(np.stack([col4, row, zero, zero], axis=-1), key)
    return gumbel_of_bits(words).reshape(rows, V)


def gumbel_softmax_sample_reference(logits: torch.Tensor, g: torch.Tensor,
                                    tau: float) -> torch.Tensor:
    """Plain version of the soft kernel, given the field g."""
    return torch.softmax((logits + g) / tau, dim=-1)


def gumbel_argmax_ids_reference(logits: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the id kernel, given the field g."""
    return torch.argmax(logits + g, dim=-1)


def draw_seed(generator: torch.Generator | None, device: torch.device) -> torch.Tensor:
    """One int64 seed in device memory, drawn from ``generator``."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def replayed_seed(state: torch.Tensor, device: torch.device | str) -> int:
    """The seed ``draw_seed`` takes from a generator of ``device`` that is in
    ``state`` (its ``get_state()`` before the wrapper's call)."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return int(draw_seed(gen, torch.device(device)).item())


def _check(name: str, logits: torch.Tensor, row0: int, *others: torch.Tensor | None) -> None:
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError(f"{name}: logits must be 2-D float32, got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    if not 0 <= row0 <= 2 ** 31 - 1 - logits.shape[0]:
        raise ValueError(f"{name}: row0 must be in [0, 2^31 - R), got {row0}")
    for t in others:
        if t is not None and (t.shape != logits.shape or t.dtype != torch.float32
                              or t.device != logits.device):
            raise ValueError(f"{name}: noise and g_out must be float32 like the "
                             f"logits {tuple(logits.shape)}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {logits.device}")
    if logits.device.type == "cuda":
        V = logits.shape[1]
        if V % 4 or not 0 < V <= MAX_V:
            raise ValueError(f"{name}: the kernel takes 0 < V <= {MAX_V} with "
                             f"V % 4 == 0, got V={V}")
        for t in (logits,) + others:
            if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"{name}: tensors must be contiguous and "
                                 "16-byte aligned")


_ARGTYPES = {   # pointers: logits, noise, out, g_out, seed; then R, V, ..., row0, stream
    SOFT_KERNEL: [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    IDS_KERNEL: [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p],
}


@functools.cache
def _entry(name: str):
    return _build.entry("gumbel", name, _ARGTYPES[name])


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _plain_field(logits, generator, noise, g_out, row0):
    if noise is None:
        R, V = logits.shape
        g = gumbel_field((row0 + R, V), generator, logits.device)[row0:]
    else:
        g = noise
    if g_out is not None:
        g_out.copy_(g)
    return g


def _soft_forward(logits, tau, generator, noise, g_out, row0):
    if logits.device.type == "cpu":
        g = _plain_field(logits, generator, noise, g_out, row0)
        return gumbel_softmax_sample_reference(logits, g, tau)
    R, V = logits.shape
    y = torch.empty_like(logits)
    seed = draw_seed(generator, logits.device)
    _build.launch_on(logits.device, SOFT_KERNEL, _entry(SOFT_KERNEL),
                     logits.data_ptr(), _ptr(noise), y.data_ptr(), _ptr(g_out),
                     seed.data_ptr(), R, V, float(tau), row0)
    return y


class _SoftSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, tau, generator, noise, g_out, row0):
        y = _soft_forward(logits, tau, generator, noise, g_out, row0)
        ctx.save_for_backward(y)
        ctx.tau = tau
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        # d softmax / tau, as ocrl_tpu/ops/gumbel.py::_soft_bwd
        (y,) = ctx.saved_tensors
        inner = (dy * y).sum(-1, keepdim=True)
        return y * (dy - inner) / ctx.tau, None, None, None, None, None


def gumbel_softmax_sample(logits: torch.Tensor, tau: float, *,
                          generator: torch.Generator | None = None,
                          noise: torch.Tensor | None = None,
                          g_out: torch.Tensor | None = None,
                          row0: int = 0) -> torch.Tensor:
    """softmax((logits + g) / tau) per row of logits [R, V]; see the module
    docstring."""
    _check("gumbel_softmax_sample", logits, row0, noise, g_out)
    return _SoftSample.apply(logits, float(tau), generator, noise, g_out, int(row0))


def gumbel_argmax_ids(logits: torch.Tensor, *,
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None,
                      g_out: torch.Tensor | None = None,
                      row0: int = 0) -> torch.Tensor:
    """argmax(logits + g) per row of logits [R, V], as int64 ids [R]; no
    gradient flows through them (ocrl_tpu/ops/gumbel.py:139-149); ``row0``
    as in the module docstring."""
    _check("gumbel_argmax_ids", logits, row0, noise, g_out)
    logits = logits.detach()
    if logits.device.type == "cpu":
        return gumbel_argmax_ids_reference(
            logits, _plain_field(logits, generator, noise, g_out, int(row0)))
    R, V = logits.shape
    ids = torch.empty(R, dtype=torch.int64, device=logits.device)
    seed = draw_seed(generator, logits.device)
    _build.launch_on(logits.device, IDS_KERNEL, _entry(IDS_KERNEL),
                     logits.data_ptr(), _ptr(noise), ids.data_ptr(), _ptr(g_out),
                     seed.data_ptr(), R, V, int(row0))
    return ids
