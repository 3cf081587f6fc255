"""SLATE's transformer decoder (counterpart of ocrl_tpu/models/transformer.py):
pre-LN blocks with depth-scaled output gains, the ``is_first`` variant,
causal self-attention and cross-attention to the slots. Plain matmuls and
softmax, as the JAX package leaves them to XLA.

Dropout draws its masks from the ``generator`` handed down each call and
acts only when ``train`` is set. The KV-cached single-token decode comes
with the evaluation slice.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import FLAX_LN_EPS, dropout, linear


class MultiHeadAttention(nn.Module):
    """ocrl_tpu/models/transformer.py:21-54."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 gain: float = 1.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.rate = dropout
        self.proj_q = linear(d_model, d_model, bias=False)
        self.proj_k = linear(d_model, d_model, bias=False)
        self.proj_v = linear(d_model, d_model, bias=False)
        self.proj_o = linear(d_model, d_model, bias=False, gain=gain)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, -1).transpose(1, 2)

    def forward(self, q, k, v, attn_mask: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        """q [B, T, d], k and v [B, S, d]; ``attn_mask`` [T, S] is True where
        attention is cut (-inf before the softmax)."""
        B, T, _ = q.shape
        hd = q.shape[-1] // self.num_heads
        q = self._split(self.proj_q(q)) * hd ** -0.5
        k = self._split(self.proj_k(k))
        v = self._split(self.proj_v(v))
        attn = q @ k.transpose(-1, -2)                       # [B, H, T, S]
        if attn_mask is not None:
            attn = attn.masked_fill(attn_mask, float("-inf"))
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(attn, self.rate, generator, train)
        out = (attn @ v).transpose(1, 2).reshape(B, T, -1)
        return dropout(self.proj_o(out), self.rate, generator, train)


class FFN(nn.Module):
    """ocrl_tpu/models/transformer.py:92-102."""

    def __init__(self, d_model: int, gain: float, dropout: float):
        super().__init__()
        self.rate = dropout
        self.fc1 = linear(d_model, 4 * d_model, weight_init="kaiming")
        self.fc2 = linear(4 * d_model, d_model, gain=gain)

    def forward(self, x, train: bool = False, generator=None):
        return dropout(self.fc2(torch.relu(self.fc1(x))), self.rate, generator, train)


class TransformerDecoderBlock(nn.Module):
    """ocrl_tpu/models/transformer.py:154-187."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 gain: float = 1.0, is_first: bool = False):
        super().__init__()
        self.is_first = is_first
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, gain)
        self.encoder_decoder_attn_layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.encoder_decoder_attn = MultiHeadAttention(d_model, num_heads, dropout, gain)
        self.ffn_layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.ffn = FFN(d_model, gain, dropout)

    def forward(self, x, encoder_output, train: bool = False, generator=None):
        T = x.shape[1]
        causal = torch.triu(torch.ones(T, T, dtype=torch.bool, device=x.device), 1)
        if self.is_first:
            x = self.self_attn_layer_norm(x)
            x = x + self.self_attn(x, x, x, causal, train, generator)
        else:
            normed = self.self_attn_layer_norm(x)
            x = x + self.self_attn(normed, normed, normed, causal, train, generator)
        normed = self.encoder_decoder_attn_layer_norm(x)
        x = x + self.encoder_decoder_attn(normed, encoder_output, encoder_output,
                                          None, train, generator)
        return x + self.ffn(self.ffn_layer_norm(x), train, generator)


class TransformerDecoder(nn.Module):
    """ocrl_tpu/models/transformer.py:210-231: blocks with the output gain
    (3 * num_blocks) ** -0.5, the first one ``is_first``, then a LayerNorm."""

    def __init__(self, num_blocks: int, max_len: int, d_model: int,
                 num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.max_len = max_len
        gain = (3 * num_blocks) ** -0.5 if num_blocks > 0 else 1.0
        self.blocks = nn.ModuleList(
            TransformerDecoderBlock(d_model, num_heads, dropout, gain, is_first=(i == 0))
            for i in range(num_blocks))
        self.layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, x, encoder_output, train: bool = False, generator=None):
        for block in self.blocks:
            x = block(x, encoder_output, train, generator)
        return self.layer_norm(x)


class LearnedPositionalEncoding(nn.Module):
    """ocrl_tpu/models/transformer.py:253-265 (batch first)."""

    def __init__(self, max_len: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.pe = nn.Parameter(nn.init.trunc_normal_(torch.empty(1, max_len, d_model),
                                                     0.0, 1.0, -2.0, 2.0))

    def forward(self, x, train: bool = False, generator=None):
        return dropout(x + self.pe[:, :x.shape[1]], self.rate, generator, train)
