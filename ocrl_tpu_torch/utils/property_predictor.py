"""The frozen-OCR property probe (counterpart of
ocrl_tpu/utils/property_predictor.py): a head predicts each object's
properties (colour, shape, scale as classes, xy as two numbers) from each
slot, and each object is matched to a slot by the Hungarian assignment of
their summed costs, per sample, on the host (scipy's
``linear_sum_assignment``, as JAX calls it).

The cost of object o against slot s is the sum over the class properties
of the cross-entropy of the slot's logits at the object's class, plus the
mean squared xy error; the loss is the sum of the matched costs over the
batch. The VAE, whose representation is one vector, predicts
``num_slots_for_dist_rep`` pseudo-slots from it; SLATE (Slot-Attention
too), SlotAttn and IODINE predict one row a slot; any other OCR raises.

A step, in the port's idiom: the OCR forward once, without autograd, on the
step's noise; the head; the cost of all (object, slot) pairs, sent to the
host in one copy; the matching; the loss gathered from the same cost and
its backward into the head alone; optax's Adam (``rl.ppo.OptaxChain``).
JAX computes the cost in one jitted pass and the loss in another, each
running the OCR on the same key, so both passes see the same
representation: one forward gives the same numbers with half the sweeps.
The metrics are those of the head before its step, as JAX's ``has_aux``
returns them, and ``R^2_xy`` is JAX's ratio of the explained to the total
sum of squares (ROADMAP.md, suspected faults of the reference), not R².

``save`` / ``load`` use JAX's tree: ``property_predictor_module_state_dict``
(flax's ``Dense_0`` ...), ``property_predictor_opt_state_dict`` (optax's
adam state) and the OCR's ``save()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch import nn

from ..models.base import normalize_obs
from ..models.common import dense
from ..rl.ppo import OptaxChain
from .checkpoint import checkpoint_tree, load_tree
from .convert import load_part_adam, part_adam_tree, part_from_flax, part_to_flax

SLOT_OCRS = ("SLATE", "SlotAttn", "Iodine")
HEAD = "head"


class Head(nn.Module):
    """flax's ``_Head``: one Dense (``linear``), or three Dense 256 with
    leaky_relu(0.01) and a Dense out (``mlp3``)."""

    def __init__(self, in_dim: int, output_size: int, model_type: str):
        super().__init__()
        if model_type == "linear":
            widths = [output_size]
        elif model_type == "mlp3":
            widths = [256, 256, 256, output_size]
        else:
            raise ValueError(f"unknown model_type '{model_type}'")
        self.dense = nn.ModuleList(dense(i, o) for i, o in zip([in_dim] + widths, widths))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            x = F.leaky_relu(layer(x), 0.01)
        return self.dense[-1](x)


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device)


class PropertyPredictor:
    """``PropertyPredictor(ocr, config, dataset_config, seed)``: ``ocr`` an
    ``OCR`` of ``models.create_ocr`` (frozen here), ``config`` a
    ``PropertyPredictorConfig``, ``dataset_config`` a ``DatasetConfig``.
    The head's weights are drawn on the CPU from ``seed``."""

    def __init__(self, ocr, config, dataset_config, seed: int = 0):
        self._ocr = ocr
        self._config = config
        self._property_list = list(dataset_config.property_order_in_state)
        props = dataset_config.properties
        self._target_idx, self._output_idx = [], []
        t, o = 0, 0
        for name in self._property_list:
            if name == "xy":
                self._target_idx.append((t, t + 2))
                self._output_idx.append((o, o + props[name]["dims"]))
            else:
                self._target_idx.append((t, t + 1))
                self._output_idx.append((o, o + props[name]["num_candidates"]))
            t, o = self._target_idx[-1][1], self._output_idx[-1][1]
        self._per_slot_size = output_size = o
        if ocr.name in SLOT_OCRS:
            self._num_pseudo = None
        elif ocr.name == "VAE":
            self._num_pseudo = config.num_slots_for_dist_rep
            output_size *= self._num_pseudo
        else:
            raise ValueError(f"{ocr.name} is not supported to predict property.")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.head = Head(ocr.rep_dim, output_size, config.model_type).to(ocr.device)
        self.param_names = [n for n, _ in self.head.named_parameters()]
        self.optimizer = OptaxChain(list(self.head.parameters()), "adam",
                                    config.learning.lr, None, 1e-8)

    # -- one batch ---------------------------------------------------------------

    def _outputs(self, obs: torch.Tensor, noise: dict | None) -> torch.Tensor:
        """obs -> per-slot predictions [B, S, per_slot_size]; the OCR runs
        without autograd (JAX's stop_gradient), ``noise`` as ``OCR.rep``
        takes it."""
        B = obs.shape[0]
        rep = self._ocr.rep(obs, noise=noise)
        if self._num_pseudo is None:
            S = rep.shape[1]
            return self.head(rep.reshape(B * S, -1)).reshape(B, S, self._per_slot_size)
        return self.head(rep).reshape(B, self._num_pseudo, self._per_slot_size)

    def _pairwise_cost(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The cost of every (object o, slot s) pair [B, O, S]."""
        cost = 0.0
        for (t0, t1), (o0, o1), name in zip(self._target_idx, self._output_idx,
                                           self._property_list):
            tgt, out = target[:, :, t0:t1], output[:, :, o0:o1]
            if name == "xy":
                cost = cost + ((tgt[:, :, None] - out[:, None]) ** 2).mean(-1)
                continue
            logp = F.log_softmax(out, dim=-1)                          # [B, S, C]
            labels = tgt[..., 0].to(torch.int64)                       # [B, O]
            B, O, S = labels.shape[0], labels.shape[1], logp.shape[1]
            picked = logp[:, None].expand(B, O, S, logp.shape[2]).gather(
                -1, labels[:, :, None, None].expand(B, O, S, 1))
            cost = cost + -picked[..., 0]
        return cost

    @staticmethod
    def _align(cost: np.ndarray) -> np.ndarray:
        """Each sample's Hungarian matching of objects to slots [B, O]."""
        col_inds = np.empty(cost.shape[:2], np.int64)
        for b in range(cost.shape[0]):
            col_inds[b] = linear_sum_assignment(cost[b])[1]
        return col_inds

    def _loss(self, obs, target, noise):
        """(loss with its graph into the head, the metrics as 0-d tensors,
        the matched columns [B, O] on the host)."""
        output = self._outputs(obs, noise)
        cost = self._pairwise_cost(output, target)
        col_np = self._align(cost.detach().cpu().numpy())
        col = torch.from_numpy(col_np).to(output.device)
        loss = cost.gather(2, col[..., None])[..., 0].sum()
        out = output.detach().gather(1, col[..., None].expand(-1, -1, output.shape[-1]))
        metrics = {"loss": loss.detach()}
        for (t0, t1), (o0, o1), name in zip(self._target_idx, self._output_idx,
                                           self._property_list):
            tgt, pred = target[:, :, t0:t1], out[:, :, o0:o1]
            if name == "xy":
                tmean = tgt.mean(dim=1, keepdim=True)
                sst = ((tgt - tmean) ** 2).sum(dim=1)
                sse = ((pred - tmean) ** 2).sum(dim=1)
                metrics[f"R^2_{name}"] = (sse / (sst + 1e-12)).mean()
                metrics[f"mse_{name}"] = ((pred - tgt) ** 2).sum(-1).sqrt().mean()
            else:
                hit = pred.argmax(-1) == tgt[..., 0].to(torch.int64)
                metrics[f"acc_{name}"] = hit.to(torch.float32).mean()
        return loss, metrics, col_np

    def _batch(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        device = self._ocr.device
        return (normalize_obs(_on(batch["obss"], device)),
                _on(batch["objs"], device).to(torch.float32))

    @staticmethod
    def _host(metrics: dict) -> dict[str, float]:
        values = torch.stack(list(metrics.values())).cpu().tolist()
        return dict(zip(metrics, values))

    def update(self, batch: dict, step: int = 0, *, noise: dict | None = None,
               matched: list | None = None) -> dict[str, float]:
        """One Adam step of the head on ``batch`` (``obss`` uint8 or float
        NHWC, ``objs`` [B, O, state]); the metrics before it. ``noise``
        gives or receives the OCR forward's draws (``OCR.rep``);
        ``matched``, a list, receives the matched columns [B, O]."""
        obs, target = self._batch(batch)
        loss, metrics, col = self._loss(obs, target, noise)
        grads = torch.autograd.grad(loss, list(self.head.parameters()))
        self.optimizer.step(grads)
        if matched is not None:
            matched.append(col)
        return self._host(metrics)

    def get_loss(self, batch: dict, *, noise: dict | None = None) -> dict[str, float]:
        """The metrics of ``batch`` without a step."""
        obs, target = self._batch(batch)
        with torch.no_grad():
            _, metrics, _ = self._loss(obs, target, noise)
        return self._host(metrics)

    def get_samples(self, obs) -> dict:
        return self._ocr.get_samples(obs)

    # -- JAX's checkpoint tree -------------------------------------------------------

    def save(self) -> dict:
        """JAX's ``PropertyPredictor.save()`` tree of this probe."""
        ckpt = {"property_predictor_module_state_dict": part_to_flax(HEAD, self.head.state_dict()),
                "property_predictor_opt_state_dict": part_adam_tree(HEAD, self.optimizer,
                                                                    self.param_names)}
        ckpt.update(checkpoint_tree(self._ocr))
        return ckpt

    def load(self, checkpoint: dict) -> None:
        """Set the head, its Adam and the OCR from JAX's tree."""
        self.head.load_state_dict(part_from_flax(
            HEAD, checkpoint["property_predictor_module_state_dict"]))
        load_part_adam(HEAD, self.optimizer, self.param_names,
                       checkpoint["property_predictor_opt_state_dict"])
        load_tree(self._ocr, checkpoint)
