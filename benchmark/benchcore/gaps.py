"""The numbers a training cell's ``correct`` compares.

For the first three steps of the timed path and of the reference from the
same weights, inputs and draws: each step's loss, the norm of each leaf's
first gradient as Adam took it, and the norm of each leaf's change after
the three steps. A loss is compared against the larger of its reference
value and the median step's. Norms are compared leaf by leaf, the gap
between the two norms (not the norm of their difference) against the
reference's norm of that leaf or of the median leaf, whichever is larger;
the worst leaf is the number, and beside it the median leaf's. Leaves whose first reference gradient is
under a thousandth of the median leaf's move under Adam by round-off alone
and are not counted; a leaf the reference never moves must not move in the
program either.
"""

from __future__ import annotations

import statistics

import torch

QUIET_SHARE = 1e-3


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.detach().to(torch.float64).norm()) for k, v in tensors.items()}


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The worst step's |program - reference| / max(|reference|, the median
    step's |reference|): a loss that passes near zero, as SAC's actor loss
    does, is measured against the losses' own scale."""
    median = statistics.median(abs(r) for r in reference)
    return max(abs(p - r) / max(abs(r), median)
               for p, r in zip(program, reference, strict=True))


def counted(ref_grad: dict[str, float]) -> list[str]:
    """Leaves whose reference gradient is at least QUIET_SHARE of the
    median leaf's."""
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= QUIET_SHARE * median]


def median(values) -> float:
    return statistics.median(values)


def leaf_gap(program: dict[str, float], reference: dict[str, float], leaves: list[str],
             pick=max) -> float:
    """The worst leaf's |program - reference| / max(reference, median leaf's
    reference); with ``pick=median`` the median leaf's, which one leaf's
    swing does not move."""
    if any(k not in program for k in leaves):
        return 1.0
    scale = statistics.median(reference[k] for k in leaves)
    return pick(abs(program[k] - reference[k]) / max(reference[k], scale) for k in leaves)


def change_gap(program: dict[str, float], reference: dict[str, float], leaves: list[str],
               unmoved: list[str], pick=max) -> float:
    """``leaf_gap`` of the changes, or 1 where the program moved a leaf
    that the reference leaves as it is (``unmoved``)."""
    if any(program.get(k, 0.0) > 0.0 for k in unmoved):
        return 1.0
    return leaf_gap(program, reference, leaves, pick)
