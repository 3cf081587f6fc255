"""The hand-written kernels as a trace shows them, and their rooflines.

B3 / B4 (the slot-routing sweep and its backward) run as one of three
plans of C entries; each call launches one kernel that marks it:

- fast: ``sweep_fwd_kernel`` (B3) / ``sweep_bwd_kernel`` (B4), each
  followed by ``reduce_rows``;
- heads: ``heads_fwd_kernel`` (B3') / ``heads_bwd_kernel`` (B4');
- streamed: B3'' launches ``wide_sums_kernel`` once, B4'' launches
  ``wide_tokens_kernel`` and ``wide_sums_kernel`` once each, beside
  ``wide_pairs_kernel``, ``wide_rows_kernel`` and ``reduce_segments``.

B1 / B2 (the Gumbel soft sample and ids) are ``gumbel_soft_kernel`` and
``gumbel_ids_kernel``. A share of the roofline is the calls' least time
(``counts``) over the measured time of every kernel of those calls.
"""

from __future__ import annotations

import re

from .counts import gumbel_bound_ms, sweep_bound_ms, sweep_bwd_bound_ms

ROUTING = re.compile(r"\b(sweep_fwd_kernel|sweep_bwd_kernel|reduce_rows|heads_fwd_kernel|"
                     r"heads_bwd_kernel|wide_pairs_kernel|wide_rows_kernel|wide_sums_kernel|"
                     r"wide_tokens_kernel|reduce_segments)\b")
GUMBEL_SOFT = re.compile(r"\bgumbel_soft_kernel\b")
GUMBEL_IDS = re.compile(r"\bgumbel_ids_kernel\b")
# cuDNN's convolution kernels, by name: chip_smoke.py's CONV_KERNELS (the
# implicit GEMMs), and the Winograd and FFT algorithms' transforms, the
# complex GEMMs of the FFT route and cuDNN's layout transforms, which
# CONV_KERNELS misses (the model computes nothing complex and uses cuDNN for
# convolutions alone)
CONV_PARTS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft2d", "cudnn",
              "cf32")


def count(ops, pattern: str) -> int:
    rx = re.compile(rf"\b{pattern}\b")
    return sum(1 for op in ops if rx.search(op.name))


def routing_calls(ops) -> tuple[int, int]:
    """(B3 calls, B4 calls) among the kernels ``ops``, whatever the plan."""
    fwd = count(ops, "sweep_fwd_kernel") + count(ops, "heads_fwd_kernel")
    bwd = count(ops, "sweep_bwd_kernel") + count(ops, "heads_bwd_kernel")
    tokens = count(ops, "wide_tokens_kernel")
    return fwd + count(ops, "wide_sums_kernel") - tokens, bwd + tokens


def routing_ms(ops) -> float:
    return sum(op.end - op.start for op in ops if ROUTING.search(op.name)) / 1e3


def routing_roofline(ops, shape: tuple[int, int, int, int, int], bw: float,
                     flops: float) -> float | None:
    """% of the bound of B3 / B4 calls, all at ``shape`` (B, N, S, D, H)."""
    measured = routing_ms(ops)
    if measured <= 0:
        return None
    B, N, S, D, H = shape
    fwd, bwd = routing_calls(ops)
    bound = (fwd * sweep_bound_ms(B, N, S, D, bw, flops, H)
             + bwd * sweep_bwd_bound_ms(B, N, S, D, bw, flops, H))
    return 100.0 * bound / measured


def gumbel_roofline(ops, R: int, V: int, bw: float, flops: float) -> float | None:
    """% of the bound of the B1 and B2 calls, all on [R, V] logits."""
    soft = [op for op in ops if GUMBEL_SOFT.search(op.name)]
    ids = [op for op in ops if GUMBEL_IDS.search(op.name)]
    measured = sum(op.end - op.start for op in soft + ids) / 1e3
    if measured <= 0:
        return None
    bound = (len(soft) * gumbel_bound_ms(R, V, True, bw, flops)
             + len(ids) * gumbel_bound_ms(R, V, False, bw, flops))
    return 100.0 * bound / measured


def is_conv(name: str) -> bool:
    return any(part in name for part in CONV_PARTS)
