"""Slot Attention (counterpart of ocrl_tpu/models/slot_attention.py).

The softmax is taken jointly over heads x slots (the competition among
slots), then renormalised over the inputs with an epsilon, as in JAX.

Two routes compute the same function:

- the sweep (``ops.route_sweep``), for every slot count and every head
  count H dividing the slot size D. On a CUDA tensor it is the hand-written
  kernels (one of three plans, chosen by the shape: ``ops.slot_routing.
  sweep_plan``); on the CPU their plain version. The renormalisation is then
  done per head from the sweep's sums:
  ``upd[b, s, c] = (A_v[b, s, c] + eps * sum_n v[b, n, c]) /
  (S_a[b, h(c) S + s] + N * eps)``, h(c) the head of column c; the
  attention returned is ``a`` summed over the heads, as JAX's
  ``attn.sum(2)``;
- the einsum route, JAX's own jnp route (ocrl_tpu/models/slot_attention.py:
  96-108), which reaches no kernel, on any device.

``fused`` keeps JAX's three values:

- ``auto`` (the port's default) takes the sweep at every shape, on any
  device;
- ``always`` raises ``ValueError`` exactly where JAX's does (more than one
  head, or no power-of-two chunk from 8 to 512 dividing N:
  ocrl_tpu/models/slot_attention.py:71-77) and takes the sweep elsewhere;
- ``never`` takes the einsum route, also on the card: only a user's explicit
  value reaches it.
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

    def _use_sweep(self, N: int) -> bool:
        H = self.num_heads
        if self.fused == "never":
            return False
        if self.fused == "always" and (H != 1 or slot_routing.pick_chunk(N) == 0):
            raise ValueError(
                f"fused=always but routing is ineligible (heads={H}, N={N}, "
                f"chunk={slot_routing.pick_chunk(N)})")
        return True

    def forward(self, inputs: torch.Tensor, slots: torch.Tensor):
        """inputs [B, N, D_in], slots [B, S, D] -> (slots [B, S, D],
        attention [B, N, S] of the last iteration, summed over the heads)."""
        B, N, _ = inputs.shape
        S, H = self.num_slots, self.num_heads
        hd = self.slot_size // H
        use_sweep = self._use_sweep(N)

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
                sa, av, attn_vis = slot_routing.route_sweep(k, v, q, H)
                if H == 1:
                    updates = (av + self.epsilon * v_sum[:, None, :]) \
                        / (sa + N * self.epsilon)[..., None]
                else:   # each column over its own head's S_a
                    denom = (sa + N * self.epsilon).reshape(B, H, S).transpose(1, 2)
                    updates = ((av + self.epsilon * v_sum[:, None, :]).reshape(B, S, H, hd)
                               / denom[..., None]).reshape(B, S, self.slot_size)
                    attn_vis = attn_vis.reshape(B, N, H, S).sum(2)
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
