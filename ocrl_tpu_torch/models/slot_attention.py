"""Slot Attention (counterpart of ocrl_tpu/models/slot_attention.py).

The softmax is taken jointly over heads x slots (the competition among
slots), then renormalised over the inputs with an epsilon, as in JAX.

Two routes compute the same function:

- the sweep (``ops.route_sweep``): one head, S <= 16 slots, slot size a
  multiple of 32 up to 256. On a CUDA tensor it is the hand-written kernel;
  on the CPU its plain version. The renormalisation is then done from the
  sweep's sums:
  ``upd = (A_v + eps * sum_n v) / (S_a + N * eps)``;
- the einsum route, the plain version of the whole loop, for any head count.

``fused`` keeps JAX's three values, with JAX's ``auto`` semantics: ``auto``
takes the sweep whenever it is eligible, ``always`` raises when it is not,
``never`` takes the einsum route. On a CUDA tensor this slice runs the sweep
only: ``never``, and more than one head, raise there rather than hide the
device path behind a silent einsum.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import slot_routing
from .common import FLAX_LN_EPS, FusedGRUCell, linear, randn

FUSED_MODES = ("never", "auto", "always")


class SlotAttention(nn.Module):
    """ocrl_tpu/models/slot_attention.py:20-122."""

    def __init__(self, num_iterations: int, num_slots: int, input_size: int,
                 slot_size: int, mlp_hidden_size: int, num_heads: int,
                 epsilon: float = 1e-8, fused: str = "auto"):
        super().__init__()
        if fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got '{fused}'")
        self.num_iterations = num_iterations
        self.num_slots = num_slots
        self.slot_size = slot_size
        self.num_heads = num_heads
        self.epsilon = epsilon
        self.fused = fused
        self.norm_inputs = nn.LayerNorm(input_size, eps=FLAX_LN_EPS)
        self.norm_slots = nn.LayerNorm(slot_size, eps=FLAX_LN_EPS)
        self.norm_mlp = nn.LayerNorm(slot_size, eps=FLAX_LN_EPS)
        self.project_q = linear(slot_size, slot_size, bias=False)
        self.project_k = linear(input_size, slot_size, bias=False)
        self.project_v = linear(input_size, slot_size, bias=False)
        self.gru = FusedGRUCell(slot_size, slot_size)
        self.mlp = nn.Sequential(
            linear(slot_size, mlp_hidden_size, weight_init="kaiming"),
            nn.ReLU(),
            linear(mlp_hidden_size, slot_size),
        )

    def _use_sweep(self, device: torch.device) -> bool:
        eligible = (self.num_heads == 1 and
                    slot_routing.sweep_supports(self.num_slots, self.slot_size))
        if self.fused == "always" and not eligible:
            raise ValueError(
                f"fused=always but routing is ineligible (heads={self.num_heads}, "
                f"slots={self.num_slots}, slot_size={self.slot_size})")
        if device.type == "cuda":
            if self.fused == "never":
                raise ValueError(
                    "fused=never: the einsum route is the plain version and "
                    "does not run on CUDA in this slice; use auto or always")
            if not eligible:
                raise NotImplementedError(
                    f"heads={self.num_heads}, slots={self.num_slots}, "
                    f"slot_size={self.slot_size}: the routing kernel takes one "
                    "head, at most 16 slots and a slot size that is a multiple "
                    "of 32 up to 256")
        return eligible and self.fused != "never"

    def forward(self, inputs: torch.Tensor, slots: torch.Tensor):
        """inputs [B, N, D_in], slots [B, S, D] -> (slots [B, S, D],
        attention [B, N, S] of the last iteration)."""
        B, N, _ = inputs.shape
        S, H = self.num_slots, self.num_heads
        hd = self.slot_size // H
        use_sweep = self._use_sweep(inputs.device)

        inputs = self.norm_inputs(inputs)
        k = self.project_k(inputs) * hd ** -0.5          # [B, N, H*hd]
        v = self.project_v(inputs)
        if use_sweep:
            v_sum = v.sum(1)                              # [B, D]
        else:
            k = k.reshape(B, N, H, hd)
            v = v.reshape(B, N, H, hd)

        attn_vis = None
        for _ in range(self.num_iterations):
            slots_prev = slots
            q = self.project_q(self.norm_slots(slots))    # [B, S, D]
            if use_sweep:
                sa, av, attn_vis = slot_routing.route_sweep(k, v, q)
                updates = (av + self.epsilon * v_sum[:, None, :]) \
                    / (sa + N * self.epsilon)[..., None]
            else:
                q = q.reshape(B, S, H, hd)
                logits = torch.einsum("bnhd,bshd->bnhs", k, q)
                attn = torch.softmax(logits.reshape(B, N, H * S), dim=-1)
                attn = attn.reshape(B, N, H, S)
                attn_vis = attn.sum(2)
                attn = attn + self.epsilon
                attn = attn / attn.sum(dim=1, keepdim=True)
                updates = torch.einsum("bnhs,bnhd->bshd", attn, v)
                updates = updates.reshape(B, S, self.slot_size)
            slots = self.gru(slots_prev.reshape(-1, self.slot_size),
                             updates.reshape(-1, self.slot_size))
            slots = slots.reshape(B, S, self.slot_size)
            slots = slots + self.mlp(self.norm_mlp(slots))
        return slots, attn_vis


class SlotAttentionEncoder(nn.Module):
    """Feature tokens -> slots (ocrl_tpu/models/slot_attention.py:125-163).

    The initial slots are ``mu + exp(log_sigma) * noise`` with standard
    normal noise, drawn at every call from ``generator`` unless ``noise``
    [B, S, D] is given.
    """

    def __init__(self, num_iterations: int, num_slots: int,
                 input_channels: int, slot_size: int, mlp_hidden_size: int,
                 num_heads: int, fused: str = "auto"):
        super().__init__()
        self.num_slots = num_slots
        self.slot_size = slot_size
        self.layer_norm = nn.LayerNorm(input_channels, eps=FLAX_LN_EPS)
        self.mlp = nn.Sequential(
            linear(input_channels, input_channels, weight_init="kaiming"),
            nn.ReLU(),
            linear(input_channels, input_channels),
        )
        # flax's xavier_uniform on a (1, 1, D) parameter: fan_in 1, fan_out D
        bound = math.sqrt(6.0 / (1 + slot_size))
        self.slot_mu = nn.Parameter(torch.empty(1, 1, slot_size).uniform_(-bound, bound))
        self.slot_log_sigma = nn.Parameter(
            torch.empty(1, 1, slot_size).uniform_(-bound, bound))
        self.slot_attention = SlotAttention(
            num_iterations, num_slots, input_channels, slot_size,
            mlp_hidden_size, num_heads, fused=fused)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """x [B, N, input_channels] -> (slots [B, S, D], attention [B, N, S])."""
        B = x.shape[0]
        x = self.mlp(self.layer_norm(x))
        if noise is None:
            noise = randn((B, self.num_slots, self.slot_size), generator, x.device,
                          dtype=x.dtype)
        elif noise.shape != (B, self.num_slots, self.slot_size):
            raise ValueError(f"noise must be {(B, self.num_slots, self.slot_size)}, "
                             f"got {tuple(noise.shape)}")
        slots = self.slot_mu + torch.exp(self.slot_log_sigma) * noise
        return self.slot_attention(x, slots)
