"""The OCR wrapper (counterpart of ocrl_tpu/models/base.py): owns the module,
its optimizer and its random state, and takes training steps.

A step is the JAX train step of base.py:138-149: the loss and its gradients,
the ``norm`` metric and the clip over every parameter together, by the
inf-norm (SLATE) or the 2-norm (IODINE), then the optimizer; an OCR with
no clip reports no ``norm``. ``update_many`` takes k such steps in a Python
loop on the device, where JAX scans them in one program. Random state is
one ``torch.Generator`` on the model's device, seeded from ``seed``.
``MultiGroupAdam`` is the optimizer of every OCR that trains.

Under data parallelism (``parallel.shard_ocr``, the counterpart of the five
step functions that ocrl_tpu/parallel/mesh.py re-jits) each rank passes its
own rows of every batch; a step averages the gradients and the metrics over
the ranks in one all-reduce before the clip, ``get_loss`` reports the
global batch's metrics, ``rep`` returns the rank's rows and
``get_samples`` the grid of the whole batch. The OCR's generator carries
the shard (``common.shard_draws``), so every draw of its module is the
rank's rows of one process's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import gather_rows, mean_over_ranks
from .common import randn


def normalize_obs(obs: torch.Tensor) -> torch.Tensor:
    """uint8 images become float32 in [0, 1] on their device; float inputs
    are taken as already in [0, 1] (base.py:289-295)."""
    if obs.dtype == torch.uint8:
        return obs.to(torch.float32) / 255.0
    return obs.to(torch.float32)


def clip_by_total_norm(params: list[torch.Tensor], max_norm: float,
                       ord: float = float("inf")) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by
    min(1, max_norm / (total + 1e-6)) and return ``total``, the ``ord``-norm
    of all of them together (the max |g| for the inf-norm): the clip and
    the ``norm`` metric of base.py:22-52. torch's clip_grad_norm_ computes
    exactly this formula for either order."""
    return nn.utils.clip_grad_norm_(params, max_norm, norm_type=ord)


class MultiGroupAdam:
    """optax's adam, adamw, or a multi_transform of them over named groups
    of parameters: ``groups`` maps a name to (parameters, lr schedule,
    weight decay). A schedule takes optax's ``count`` (0 at the first
    update) and is evaluated here at this optimizer's own count. A decayed
    group takes p -= lr * (adam + weight_decay * p) (torch's AdamW computes
    the same update), the others plain Adam."""

    def __init__(self, groups: dict[str, tuple[list[torch.Tensor], Callable[[int], float], float]],
                 betas: tuple[float, float] = (0.9, 0.999)):
        self.schedules = {name: schedule for name, (_, schedule, _) in groups.items()}
        self.adam = torch.optim.AdamW(
            [{"params": params, "group": name, "weight_decay": decay}
             for name, (params, _, decay) in groups.items()],
            lr=0.0, betas=betas, eps=1e-8)
        self.count = 0

    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.schedules[group["group"]](self.count)
        self.adam.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = state["count"]


def constant(lr: float) -> Callable[[int], float]:
    return lambda count: lr


def _stack(values: list) -> torch.Tensor:
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return torch.tensor(values)


class OCR:
    """Host-side handle of one OCR model: ``update``, ``update_many``,
    ``get_loss``, ``get_samples``, ``save`` / ``load``. GT has no
    optimizer: its ``update`` and ``update_many`` take no step and return
    {}, as JAX's do."""

    def __init__(self, module: nn.Module, optimizer: MultiGroupAdam | None,
                 clip: float | None, seed: int, device: torch.device,
                 clip_ord: float = float("inf")):
        self.module = module
        self.optimizer = optimizer
        self.clip, self.clip_ord = clip, clip_ord
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._last_step = 0
        # the data-parallel shard (rank, world size) and its process group,
        # set by parallel.shard_ocr; None in one process
        self.shard: tuple[int, int] | None = None
        self.group = None

    def _on_device(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return x.to(self.device, non_blocking=True)

    def _obs(self, obs) -> torch.Tensor:
        return normalize_obs(self._on_device(obs))

    def _masks(self, masks) -> torch.Tensor | None:
        """Masks [B, K, H, W, 1] (background last) as float32 on the device,
        their values as given (base.py:301-302)."""
        return None if masks is None else self._on_device(masks).to(torch.float32)

    def _step(self, obs: torch.Tensor, masks: torch.Tensor | None, step: int,
              noise: dict | None) -> dict:
        self.module.train()
        self.optimizer.zero_grad()
        loss, metrics = self.module.loss(obs, masks, step, True,
                                         generator=self.generator, noise=noise)
        loss.backward()
        if self.shard is not None:
            grads = [p.grad for p in self.module.parameters() if p.grad is not None]
            metrics = self._mean_over_ranks(metrics, grads)
        if self.clip is not None:
            metrics["norm"] = clip_by_total_norm(list(self.module.parameters()), self.clip,
                                                 self.clip_ord)
        self.optimizer.step()
        return {k: v.detach() if isinstance(v, torch.Tensor) else v
                for k, v in metrics.items()}

    def update(self, obs, masks, step: int, *, noise: dict | None = None) -> dict:
        """One optimizer step on a batch of observations (uint8 or float in
        [0, 1], NHWC), with masks [B, K, H, W, 1] an ``ari`` metric too.
        Returns the metrics, tensors left on the device. ``noise``, a dict,
        holds the module's draws to use, or receives those it makes (each
        module's docstring names its keys)."""
        self._last_step = int(step)
        if self.optimizer is None:
            return {}
        return self._step(self._obs(obs), self._masks(masks), int(step), noise)

    def update_many(self, obs, masks, step: int, k: int, *,
                    noise: dict | None = None) -> dict:
        """k optimizer steps (step .. step+k-1) over a superbatch of k*B
        observations (and masks), one batch each. Returns the metrics
        stacked (k,). ``noise`` is given to every one of the k steps, so a
        draw it holds (or the first step records) serves them all."""
        if self.optimizer is None:
            self._last_step = int(step) + k - 1
            return {}
        obs, masks = self._obs(obs), self._masks(masks)
        if obs.shape[0] % k:
            raise ValueError(f"superbatch of {obs.shape[0]} is not k={k} batches")
        batches = obs.reshape((k, obs.shape[0] // k) + obs.shape[1:])
        if masks is not None:
            masks = masks.reshape((k, masks.shape[0] // k) + masks.shape[1:])
        steps = [self._step(batches[i], None if masks is None else masks[i],
                            int(step) + i, noise) for i in range(k)]
        self._last_step = int(step) + k - 1
        return {key: _stack([m[key] for m in steps]) for key in steps[0]}

    @torch.no_grad()
    def get_loss(self, obs, masks=None, step: int | None = None, *,
                 noise: dict | None = None) -> dict:
        """Eval metrics at the current training step's schedules (tau of
        the last step trained, 0 for a fresh or loaded OCR; base.py:226-234);
        with masks an ``ari`` metric too. ``noise`` as for ``update``."""
        self.module.eval()
        step = self._last_step if step is None else step
        _, metrics = self.module.loss(self._obs(obs), self._masks(masks), step, False,
                                      generator=self.generator, noise=noise)
        if self.shard is not None:
            metrics = self._mean_over_ranks(metrics)
        return metrics

    def _mean_over_ranks(self, metrics: dict, grads: list[torch.Tensor] = ()) -> dict:
        """The metrics (their tensors) averaged over the ranks, and
        ``grads`` in place, in one all-reduce. Every loss term of the OCRs
        is a mean over the batch's rows whose count does not depend on the
        data (MAE's masked patches are B x (N - kept) by its config), so
        the mean of the ranks' equal shares is the global batch's."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        means = mean_over_ranks(list(grads) + [metrics[k].detach() for k in keys], self.group)
        for g, mean in zip(grads, means):
            g.copy_(mean)
        return {**metrics, **dict(zip(keys, means[len(grads):]))}

    def rep(self, obs, *, noise: dict | None = None, grad: bool = False) -> torch.Tensor:
        """The representation of ``obs`` (uint8 or float NHWC), the module
        in eval mode, with autograd only where ``grad`` is set and autograd
        is on. ``noise``, a dict, gives the forward's draws under ``rep``
        (SLATE's initial slots, IODINE's eps) or receives those drawn here
        from the OCR's generator."""
        obs = self._obs(obs)
        draws = None if noise is None else noise.get("rep")
        if draws is None:
            shape_fn = getattr(self.module, "noise_shape", None)
            shape = shape_fn(obs.shape[0]) if shape_fn is not None else None
            if shape is not None:
                draws = randn(shape, self.generator, self.device,
                              getattr(self.module, "noise_batch_axis", 0))
                if noise is not None:
                    noise["rep"] = draws
        self.module.eval()
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
            return self.module(obs, noise=draws, generator=self.generator)

    @torch.no_grad()
    def get_samples(self, obs, *, noise: dict | None = None) -> dict:
        """The module's sample grid {"samples": uint8 [B, H', W', C]}, from
        its ``sample_arrays`` brought to the host (base.py:258-268); under a
        shard, the whole batch's, every rank's arrays gathered."""
        self.module.eval()
        kwargs = {} if noise is None else {"noise": noise}
        arrays = self.module.sample_arrays(self._obs(obs), generator=self.generator, **kwargs)
        if self.shard is not None:
            arrays = gather_rows(arrays, self.group)
        return self.module.samples_grid(*(a.detach().cpu().numpy() for a in arrays))

    def save(self) -> dict:
        ckpt = {"ocr_module_state_dict": self.module.state_dict()}
        if self.optimizer is not None:
            ckpt["ocr_opt_state_dict"] = self.optimizer.state_dict()
        return ckpt

    def load(self, checkpoint: dict) -> None:
        self.module.load_state_dict(checkpoint["ocr_module_state_dict"])
        if self.optimizer is not None and "ocr_opt_state_dict" in checkpoint:
            self.optimizer.load_state_dict(checkpoint["ocr_opt_state_dict"])
