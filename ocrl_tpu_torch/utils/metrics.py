"""Segmentation metrics on the device and the host's matching
(counterpart of ocrl_tpu/utils/metrics.py).

``adjusted_rand_index`` counts a contingency table from one-hot labelings
and evaluates the ARI formula in float32, as the JAX package does; the
counts are integers below 2^24 at 64x64 images, so they are exact and only
the final formula rounds. ``calculate_ari`` takes each pixel's label as
the first largest mask (``torch.argmax``, like ``jnp.argmax``, returns the
first of tied maxima). ``hungarian_matching`` is scipy's
``linear_sum_assignment`` on an L1 cost, on the host, as JAX calls it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment


def adjusted_rand_index(true_ids: torch.Tensor, pred_ids: torch.Tensor,
                        num_true: int, num_pred: int) -> torch.Tensor:
    """ARI between two integer labelings [..., P] with values below
    ``num_true`` / ``num_pred``; [...] float32. Two trivial partitions
    score 1.0 (sklearn's convention)."""
    t = F.one_hot(true_ids, num_true).to(torch.float32)
    p = F.one_hot(pred_ids, num_pred).to(torch.float32)
    cont = torch.einsum("...pi,...pj->...ij", t, p)     # [..., num_true, num_pred]
    a = cont.sum(-1)
    b = cont.sum(-2)
    n = cont.sum((-1, -2))

    def comb2(x):
        return x * (x - 1.0) / 2.0

    sum_comb = comb2(cont).sum((-1, -2))
    sum_a = comb2(a).sum(-1)
    sum_b = comb2(b).sum(-1)
    expected = sum_a * sum_b / torch.clamp(comb2(n), min=1.0)
    denom = 0.5 * (sum_a + sum_b) - expected
    degenerate = denom == 0.0
    ari = (sum_comb - expected) / torch.where(degenerate, torch.ones_like(denom), denom)
    return torch.where(degenerate, torch.ones_like(ari), ari)


def mask_labels(masks: torch.Tensor) -> torch.Tensor:
    """Masks [B, K, ...] -> each pixel's label [B, P], the first largest of
    its K masks."""
    return masks.reshape(masks.shape[0], masks.shape[1], -1).argmax(1)


def calculate_ari(true_masks: torch.Tensor, pred_masks: torch.Tensor) -> torch.Tensor:
    """Per-sample ARI [B] from mask stacks [B, K, H, W, 1], the cluster axis
    at dim 1."""
    return adjusted_rand_index(mask_labels(true_masks), mask_labels(pred_masks),
                               true_masks.shape[1], pred_masks.shape[1])


def hungarian_matching(target: np.ndarray, inputs: np.ndarray, return_diff_mat: bool = False):
    """The column of ``inputs`` [N, D] assigned to each row of ``target``
    [N, D] by the least summed L1 distance (ocrl_tpu/utils/metrics.py:63-75);
    with ``return_diff_mat`` also the distances [N, N] with their columns
    in that order."""
    target, inputs = np.asarray(target), np.asarray(inputs)
    assert target.shape == inputs.shape
    diff_mat = np.abs(target[:, None, :] - inputs[None, :, :]).sum(-1)
    _, col_ind = linear_sum_assignment(diff_mat)
    if return_diff_mat:
        return col_ind, diff_mat[:, col_ind]
    return col_ind
