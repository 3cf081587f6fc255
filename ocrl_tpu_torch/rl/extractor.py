"""Policy construction (counterpart of ocrl_tpu/rl/extractor.py): OCR +
pooling + actor-critic heads (PPO, A2C) or actor and twin critics (SAC),
for every OCR and pooling of the port.

The JAX freeze rule (ocrl_tpu/rl/extractor.py:24-25): a configured OCR
checkpoint (``pooling.ocr_checkpoint``) makes the OCR pretrained, and a
pretrained OCR is frozen unless ``finetuning``; without a checkpoint the OCR
trains end to end with the policy. ``build_policy`` loads the checkpoint's
OCR through ``utils.checkpoint.get_ocr`` and sets ``policy.freeze_ocr``.
``utils.convert.from_flax`` carries a whole JAX policy across.
"""

from __future__ import annotations

import torch

from ..config import PolicyConfig
from ..device import resolve_device
from ..models import build_module, dims
from ..poolings import create_pooling_module, pooled_dim
from ..utils.checkpoint import get_ocr, resolve_ocr_checkpoint_path
from .ac_nets import ActorCriticPolicy
from .sac import SAC, SACPolicy


def build_policy(config: PolicyConfig, seed: int = 0,
                 device: str | torch.device | None = None) -> ActorCriticPolicy:
    """The policy of ``config`` (any config with ``ocr``, ``pooling``,
    ``sb3_acnet`` and ``env``) on ``device`` (CUDA unless asked otherwise),
    in eval mode, its OCR frozen by the JAX rule. Its weights are drawn on
    the CPU from ``seed``, so a seed gives the same weights on every
    device."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ocr = build_module(config.ocr, config.env)
        rep_dim, num_slots = dims(config.ocr, config.env)
        name, stacked = config.pooling.name, config.env.num_stacked_obss
        pooling = create_pooling_module(name, rep_dim, num_slots, config.pooling, stacked)
        policy = ActorCriticPolicy(ocr, pooling, config.sb3_acnet,
                                   pooled_dim(name, config.pooling, rep_dim, num_slots, stacked),
                                   getattr(config, "num_actions", 4), freeze_ocr=False)
    policy = policy.to(device).eval()
    cpt = config.pooling.ocr_checkpoint
    if resolve_ocr_checkpoint_path(cpt) is not None:
        pretrained, _ = get_ocr(config.ocr, config.env, cpt, seed, device)
        inject_pretrained_ocr(policy, pretrained)
        policy.freeze_ocr = not cpt.finetuning
    return policy


def build_sac_policy(config, action_space, seed: int = 0,
                     device: str | torch.device | None = None):
    """-> (SACPolicy, the pretrained OCR or None) for a continuous-action
    env (ocrl_tpu/rl/extractor.py:39-58), on ``device``, its weights drawn
    on the CPU from ``seed``; ``policy.freeze_ocr`` says whether the OCR is
    frozen. The policy's OCR stays at its random init: ``SAC`` copies it
    into the target first, and ``inject_pretrained_ocr(sac, ocr)`` then
    loads the pretrained OCR into the online network alone, as JAX's order
    leaves it."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ocr_module = build_module(config.ocr, config.env)
        rep_dim, num_slots = dims(config.ocr, config.env)
        name, stacked = config.pooling.name, config.env.num_stacked_obss
        pooling = create_pooling_module(name, rep_dim, num_slots, config.pooling, stacked)
        policy = SACPolicy(ocr_module, pooling,
                           pooled_dim(name, config.pooling, rep_dim, num_slots, stacked),
                           int(action_space.shape[0]))
    policy = policy.to(device).eval()
    cpt = config.pooling.ocr_checkpoint
    ocr = None
    if resolve_ocr_checkpoint_path(cpt) is not None:
        ocr, _ = get_ocr(config.ocr, config.env, cpt, seed, device)
    policy.freeze_ocr = ocr is not None and not cpt.finetuning
    return policy, ocr


def inject_pretrained_ocr(target, ocr) -> None:
    """Replace the fresh OCR parameters of ``target`` with those of ``ocr``
    (an ``OCR`` from ``get_ocr``), whose module may hold more (a decoder)
    than the policy's serving module. ``target`` is a policy, a
    ``MultiSeedPPO`` (the OCR goes to every seed, S stacked copies, the
    layout of JAX's stacked tree) or a ``SAC`` (the online network's OCR
    alone: the target keeps its random OCR, as JAX leaves it); the last two
    make their optimizer state anew (ocrl_tpu/rl/extractor.py:61-77)."""
    state = ocr.module.state_dict()
    if isinstance(target, SAC):
        inject_pretrained_ocr(target.policy, ocr)
        target._new_optimizers()
        return
    if hasattr(target, "seeds"):
        prefix = "ocr_module."
        with torch.no_grad():
            for name, value in target.params.items():
                if name.startswith(prefix):
                    value.copy_(state[name[len(prefix):]].to(value.device).expand_as(value))
        target._new_optimizer()
        return
    own = target.ocr_module.state_dict()
    target.ocr_module.load_state_dict({k: state[k].to(own[k].device) for k in own})
