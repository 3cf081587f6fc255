"""The yardstick's arithmetic: the card's published peaks, the bytes and
operations each hand-written kernel must move or do, and the FLOPs of the
layers a model is built from. Copied from chip_smoke.py (``CARD_RATES``,
``card_rates``, ``sweep_bytes``, ``sweep_bound_ms``, ``sweep_bwd_bytes``,
``sweep_bwd_bound_ms``, ``gumbel_bytes``, ``gumbel_bound_ms``) and kept
here, where the program's changes cannot reach them."""

from __future__ import annotations

# Published rates (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and fp32 FLOP/s outside the tensor cores.
CARD_RATES = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def card_rates(name: str) -> tuple[str, float, float]:
    """(the CARD_RATES key, bytes/s, fp32 FLOP/s) of a card's name."""
    for key, (bw, flops) in CARD_RATES.items():   # most specific names first
        if all(word in name for word in key.split()):
            return key, bw, flops
    raise ValueError(f"no published rates for '{name}' in CARD_RATES")


def _bound(t_bytes: float, t_ops: float) -> float:
    return 1e3 * max(t_bytes, t_ops)


def sweep_bytes(B: int, N: int, S: int, D: int, H: int = 1) -> int:
    """Bytes route_sweep (B3) must move: read k, v, q once, write a
    [B, N, H S], S_a [B, H S] and A_v once."""
    return 4 * (2 * B * N * D + B * S * D + B * N * H * S + B * H * S + B * S * D)


def sweep_bound_ms(B: int, N: int, S: int, D: int, bw: float, flops: float,
                   H: int = 1) -> float:
    """Least time for B3: its bytes; two [N, S, D] products and the
    softmax over H S per token."""
    ops = 4 * B * N * S * D + 4 * B * N * H * S
    return _bound(sweep_bytes(B, N, S, D, H) / bw, ops / flops)


def sweep_bwd_bytes(B: int, N: int, S: int, D: int, H: int = 1) -> int:
    """Bytes the sweep's backward (B4) must move: read k, v, a, g_a, q,
    g_av once, write gk, gv, gq once."""
    return 4 * (4 * B * N * D + 2 * B * N * H * S + 3 * B * S * D)


def sweep_bwd_bound_ms(B: int, N: int, S: int, D: int, bw: float, flops: float,
                       H: int = 1) -> float:
    """Least time for B4: its bytes; per token 8 S D operations and 6 H S."""
    ops = 8 * B * N * S * D + 6 * B * N * H * S
    return _bound(sweep_bwd_bytes(B, N, S, D, H) / bw, ops / flops)


def gumbel_bytes(R: int, V: int, soft: bool) -> int:
    """Bytes one Gumbel kernel (B1 soft, B2 ids) must move: read the logits
    and the seed once, write y [R, V] fp32 (soft) or the ids [R] int64."""
    return 4 * R * V + 8 + (4 * R * V if soft else 8 * R)


def gumbel_bound_ms(R: int, V: int, soft: bool, bw: float, flops: float) -> float:
    """Least time for one Gumbel kernel: its bytes; per value about 10 fp32
    operations (soft) or 5 (ids)."""
    ops = (10 if soft else 5) * R * V
    return _bound(gumbel_bytes(R, V, soft) / bw, ops / flops)


# -- model FLOPs (a multiply-add counts 2) ---------------------------------------

def conv_flops(B: int, H_out: int, W_out: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * B * H_out * W_out * c_in * c_out * k * k


def linear_flops(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def train_flops(forward: list[tuple[int, bool]]) -> int:
    """FLOPs of a forward and its backward, no recompute: each layer's
    forward, its weight gradient (same count) and, where its input needs
    a gradient (``bool``), the input gradient (same count again)."""
    return sum(f * (3 if needs_input_grad else 2) for f, needs_input_grad in forward)
