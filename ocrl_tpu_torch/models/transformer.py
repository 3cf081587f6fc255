"""SLATE's transformer decoder (counterpart of ocrl_tpu/models/transformer.py):
pre-LN blocks with depth-scaled output gains, the ``is_first`` variant,
causal self-attention and cross-attention to the slots. Plain matmuls and
softmax, as the JAX package leaves them to XLA.

Dropout draws its masks from the ``generator`` handed down each call and
acts only when ``train`` is set.

The decode path (transformer.py:56-89, 189-250, 267-270) takes one token at
a time: each block's self-attention keeps K/V caches, tensors
[blocks, B, heads, T_max, hd] that ``step`` writes in place at position t
(callers run it under ``torch.no_grad``), with the positions after t masked
with -inf before the softmax; the cross-attention's K/V over the slots are
computed once (``cross_kvs``).
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

    # -- single-token decode ----------------------------------------------

    def kv(self, x: torch.Tensor):
        """K and V [B, heads, S, hd] of a fixed source x [B, S, d]."""
        return self._split(self.proj_k(x)), self._split(self.proj_v(x))

    def step_with_kv(self, q_t: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor | None = None):
        """One query token q_t [B, d] against precomputed K/V [B, heads, S, hd];
        ``mask`` [S] is True where attention is cut."""
        B = q_t.shape[0]
        hd = q_t.shape[-1] // self.num_heads
        q = self.proj_q(q_t).reshape(B, self.num_heads, 1, hd) * hd ** -0.5
        attn = q @ k.transpose(-1, -2)                      # [B, H, 1, S]
        if mask is not None:
            attn = attn.masked_fill(mask, float("-inf"))
        out = torch.softmax(attn, dim=-1) @ v                # [B, H, 1, hd]
        return self.proj_o(out.reshape(B, -1))

    def step_cached(self, q_t: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, t: int, after_t: torch.Tensor):
        """Causal self-attention of token t: its K/V written into the caches
        [B, heads, T_max, hd] at t, then attention over them with the
        positions ``after_t`` [T_max] (True after t) cut. Returns [B, d]."""
        B = q_t.shape[0]
        k_cache[:, :, t] = self.proj_k(q_t).reshape(B, self.num_heads, -1)
        v_cache[:, :, t] = self.proj_v(q_t).reshape(B, self.num_heads, -1)
        return self.step_with_kv(q_t, k_cache, v_cache, after_t)


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

    def cross_kv(self, encoder_output: torch.Tensor):
        return self.encoder_decoder_attn.kv(encoder_output)

    def step(self, x_t, k_cache, v_cache, t: int, after_t, cross_k, cross_v):
        """One decode token x_t [B, d]; writes this block's caches at t."""
        if self.is_first:
            x_t = self.self_attn_layer_norm(x_t)
            x_t = x_t + self.self_attn.step_cached(x_t, k_cache, v_cache, t, after_t)
        else:
            normed = self.self_attn_layer_norm(x_t)
            x_t = x_t + self.self_attn.step_cached(normed, k_cache, v_cache, t, after_t)
        normed = self.encoder_decoder_attn_layer_norm(x_t)
        x_t = x_t + self.encoder_decoder_attn.step_with_kv(normed, cross_k, cross_v)
        return x_t + self.ffn(self.ffn_layer_norm(x_t))


class TransformerDecoder(nn.Module):
    """ocrl_tpu/models/transformer.py:210-231: blocks with the output gain
    (3 * num_blocks) ** -0.5, the first one ``is_first``, then a LayerNorm."""

    def __init__(self, num_blocks: int, max_len: int, d_model: int,
                 num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.max_len = max_len
        # row t: the positions after t, cut from token t's self-attention
        self.register_buffer("after", torch.ones(max_len, max_len, dtype=torch.bool).triu(1),
                             persistent=False)
        gain = (3 * num_blocks) ** -0.5 if num_blocks > 0 else 1.0
        self.blocks = nn.ModuleList(
            TransformerDecoderBlock(d_model, num_heads, dropout, gain, is_first=(i == 0))
            for i in range(num_blocks))
        self.layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, x, encoder_output, train: bool = False, generator=None):
        for block in self.blocks:
            x = block(x, encoder_output, train, generator)
        return self.layer_norm(x)

    def make_caches(self, batch: int, device=None, dtype=torch.float32):
        """Zeroed K and V caches [blocks, B, heads, max_len, hd]."""
        attn = self.blocks[0].self_attn
        d = attn.proj_q.in_features
        shape = (len(self.blocks), batch, attn.num_heads, self.max_len,
                 d // attn.num_heads)
        return (torch.zeros(shape, device=device, dtype=dtype),
                torch.zeros(shape, device=device, dtype=dtype))

    def cross_kvs(self, encoder_output: torch.Tensor):
        """Each block's cross-attention K and V, stacked [blocks, B, heads, S, hd]."""
        ks, vs = zip(*(block.cross_kv(encoder_output) for block in self.blocks))
        return torch.stack(ks), torch.stack(vs)

    def step(self, x_t, k_caches, v_caches, t: int, cross_ks, cross_vs):
        """One token x_t [B, d] through every block, writing the caches in
        place at t."""
        for i, block in enumerate(self.blocks):
            x_t = block.step(x_t, k_caches[i], v_caches[i], t, self.after[t],
                             cross_ks[i], cross_vs[i])
        return self.layer_norm(x_t)


class LearnedPositionalEncoding(nn.Module):
    """ocrl_tpu/models/transformer.py:253-265 (batch first)."""

    def __init__(self, max_len: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.pe = nn.Parameter(nn.init.trunc_normal_(torch.empty(1, max_len, d_model),
                                                     0.0, 1.0, -2.0, 2.0))

    def forward(self, x, train: bool = False, generator=None):
        return dropout(x + self.pe[:, :x.shape[1]], self.rate, generator, train)

    def slice_at(self, t: int) -> torch.Tensor:
        """pe[t] for the decode path: [1, d]."""
        return self.pe[0, t:t + 1]
