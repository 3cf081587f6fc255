"""The pooling wrapper (counterpart of ocrl_tpu/poolings/wrapper.py:66-164):
an OCR and a pooling module, in the reference's three modes.

``Pooling(ocr, config)(obs)`` is the pooled representation:
- frozen (neither flag): the OCR runs without autograd (JAX's
  stop_gradient);
- ``learn_downstream_loss``: the OCR runs with autograd, so a caller's
  backward reaches it;
- ``learn_aux_loss`` with ``with_loss=True``: also the OCR's own loss
  metrics at step 0 in training mode, ``loss`` renamed ``aux_loss``, each
  with its graph; JAX draws them on other keys than the representation,
  so the port draws them first and the representation's noise after.

``noise``, a dict, gives or records the draws: ``rep`` the forward's (the
initial slots, IODINE's eps), and the loss's under the OCR module's own
names (SLATE's ``soft``, ``ids``, ``slots``). A configured
``ocr_checkpoint`` is loaded into the OCR at construction, its optimizer
state too. With ``learning.lr`` set the wrapper keeps an Adam state of its
own (optax's, zeros), which ``save`` writes under JAX's keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import normalize_obs
from ..rl.ppo import OptaxChain
from ..utils.checkpoint import checkpoint_tree, load_ocr_file, load_tree, \
    resolve_ocr_checkpoint_path
from ..utils.convert import attention_heads, load_part_adam, part_adam_tree, part_from_flax, \
    part_to_flax
from .modules import create_pooling_module, pooled_dim

PART = "pooling_module"


class Pooling:
    """``Pooling(ocr, config, num_stacked_obss, seed, device)``: ``ocr`` an
    ``OCR`` of ``models.create_ocr``, ``config`` a pooling config; the
    module's weights are drawn on the CPU from ``seed`` + 1 and live on
    ``device`` (the OCR's when None)."""

    def __init__(self, ocr, config, num_stacked_obss: int = 1, seed: int = 0, device=None):
        self._ocr = ocr
        self._config = config
        self.name = config.name
        self._learn_aux_loss = config.learn_aux_loss
        self._learn_downstream_loss = config.learn_downstream_loss
        self.device = ocr.device if device is None else torch.device(device)
        path = resolve_ocr_checkpoint_path(config.ocr_checkpoint)
        if path is not None:
            load_ocr_file(ocr, path)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 1)
            self.module = create_pooling_module(config.name, ocr.rep_dim, ocr.num_slots,
                                                config, num_stacked_obss).to(self.device)
        self.rep_dim = pooled_dim(config.name, config, ocr.rep_dim, ocr.num_slots,
                                  num_stacked_obss)
        self.param_names = [n for n, _ in self.module.named_parameters()]
        learning = getattr(config, "learning", None)
        self.optimizer = None
        if learning is not None and learning.lr is not None:
            self.optimizer = OptaxChain(list(self.module.parameters()), "adam", learning.lr,
                                        None, 1e-8)

    def __call__(self, obs, with_loss: bool = False, *, noise: dict | None = None):
        """The pooled representation [B, rep_dim] of ``obs`` (uint8 or float
        NHWC); with ``with_loss``, (it, the aux-loss metrics or {})."""
        ocr = self._ocr
        x = obs if isinstance(obs, torch.Tensor) else torch.from_numpy(np.asarray(obs))
        x = normalize_obs(x.to(ocr.device))
        metrics = {}
        if with_loss and self._learn_aux_loss:
            ocr.module.train()
            _, m = ocr.module.loss(x, None, 0, True, generator=ocr.generator, noise=noise)
            metrics = {("aux_loss" if k == "loss" else k): v for k, v in m.items()}
        rep = ocr.rep(x, noise=noise, grad=self._learn_downstream_loss)
        pooled = self.module(rep.to(self.device))
        return (pooled, metrics) if with_loss else pooled

    def get_samples(self, obs) -> dict:
        return self._ocr.get_samples(obs)

    def save(self) -> dict:
        """JAX's ``Pooling.save()`` tree: the pooling's params, its Adam
        state where it has one, and the OCR's ``save()``."""
        heads = attention_heads(self.module)
        ckpt = {"pooling_module_state_dict": part_to_flax(PART, self.module.state_dict(), heads)}
        if self.optimizer is not None:
            ckpt["pooling_opt_state_dict"] = part_adam_tree(PART, self.optimizer,
                                                            self.param_names, heads)
        ckpt.update(checkpoint_tree(self._ocr))
        return ckpt

    def load(self, checkpoint: dict) -> None:
        """Set the pooling, its Adam (where the tree holds one) and the OCR
        from JAX's tree."""
        self.module.load_state_dict(part_from_flax(PART, checkpoint["pooling_module_state_dict"]))
        if self.optimizer is not None and "pooling_opt_state_dict" in checkpoint:
            load_part_adam(PART, self.optimizer, self.param_names,
                           checkpoint["pooling_opt_state_dict"])
        load_tree(self._ocr, checkpoint)
