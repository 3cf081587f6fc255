"""Poolings: a set of slots -> one feature vector (counterpart of
ocrl_tpu/poolings/modules.py).

The Transformer pooling is post-LN encoder layers with a CLS token, as
torch's nn.TransformerEncoderLayer that the original pooling used, with its
embedding options (push_embedding, cw_embedding, use_mlp1, use_mlp2).
Attention is plain tensor code (matmul, softmax, matmul), as XLA runs it in
the JAX package. Dropout is left out: the JAX layers run deterministic on
the policy's path. The other poolings: RN (a relation network over ordered
slot pairs), MLP, CNN_Linear and CNN_Transformer (the slots as an image
through the Nature CNN) and Identity. Every layer is flax's default Dense
or Conv (lecun-normal kernel, zero bias); images are NHWC, and the CNN
flattens H, W, C in that order before its Dense, as JAX does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import PoolingConfigs
from ..models.common import MLP, MultiHeadDotProductAttention, dense, slot_to_img
from ..models.naturecnn import NatureCNN


class TorchEncoderLayer(nn.Module):
    """Post-norm encoder layer: self-attention, ReLU feed-forward of width
    2048, LayerNorm eps 1e-5 (ocrl_tpu/poolings/modules.py:26-47)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense(d_model, dim_feedforward)
        self.linear2 = dense(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


def sinusoid_table(max_len: int, d_model: int, scale: float = 1.0) -> np.ndarray:
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div) * scale
    pe[:, 1::2] = np.cos(position * div) * scale
    return pe


def sinusoid_div(d_model: int) -> np.ndarray:
    """The table's frequencies exp(-2i log(10^4) / d_model), i < d_model / 2,
    as float32: the float32 exponent, then exp in float64 rounded once to
    float32, so the value is the same on every device."""
    arg = np.arange(0, d_model, 2, dtype=np.float32) * np.float32(-math.log(10000.0) / d_model)
    return np.exp(arg.astype(np.float64)).astype(np.float32)


def sinusoid_lookup(x: torch.Tensor, div: torch.Tensor, max_len: int) -> torch.Tensor:
    """Coordinates in [-1, 1] quantised to rows of a sinusoid table of
    ``max_len + 1`` rows, each row computed from its index instead of looked
    up (ocrl_tpu/poolings/modules.py:140-156), in float32 in the JAX order:
    the angle is the float32 product index * div (``sinusoid_div``), sines
    at the even features, cosines at the odd. -> x.shape + (2 * div.numel(),).

    At 10^7 rows the angles reach 10^7 rad, where one ulp of a frequency
    moves an angle by up to 0.6 rad: the rows agree with JAX's where its
    exp rounds each frequency as ``sinusoid_div`` does (on the CPU XLA's
    exp is one ulp off for about a sixth of them)."""
    x = torch.clamp((x + 1) / 2, 0.0, 1.0)
    idx = torch.clamp(torch.floor(x * max_len).to(torch.int32), 0, max_len)
    ang = idx[..., None].to(torch.float32) * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        idx.shape + (2 * div.numel(),))


class CoreTransformer(nn.Module):
    """Linear projection -> CLS token -> encoder layers -> the CLS output
    (ocrl_tpu/poolings/modules.py:58-77)."""

    def __init__(self, in_dim: int, d_model: int, nhead: int, num_layers: int,
                 pos_table: np.ndarray | None = None):
        super().__init__()
        self.proj = dense(in_dim, d_model)
        self.cls_token = nn.Parameter(torch.zeros(d_model))
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead) for _ in range(num_layers))
        self.register_buffer(
            "pos_table", None if pos_table is None else torch.as_tensor(pos_table),
            persistent=False)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        B = state.shape[0]
        x = self.proj(state)
        cls = self.cls_token.expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1)
        if self.pos_table is not None:
            x = x + self.pos_table[None, : x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return x[:, 0]


def _embed(num: int, features: int) -> nn.Embedding:
    """flax nn.Embed's default init: normal, variance 1 / features."""
    m = nn.Embedding(num, features)
    nn.init.normal_(m.weight, std=features ** -0.5)
    return m


class Transformer_Module(nn.Module):
    """ocrl_tpu/poolings/modules.py:80-137. The embedding options map each
    slot row to 128 features before the transformer:

    - ``push_embedding``: the row's colour and shape ids (columns 0, 1)
      through two 10 x 128 embeddings, its last two columns (x, y) through
      ``sinusoid_lookup`` (10^7 rows), all four through a Dense;
    - ``cw_embedding`` (CausalWorld states): row 0's first 28 columns (the
      arm) and each other row's columns 28:31 (a position) through
      ``sinusoid_lookup`` (10^4 rows), the arm through ``arm_emb``, each
      object with its colour (columns 35:38) through ``obj_emb``;
    - ``use_mlp1``: Dense 64, ReLU, Dense 128; ``use_mlp2``: Dense 64, ReLU,
      Dense 64, ReLU, Dense 128 (not both: mlp1 wins, as in JAX).

    The Dense layers outside the transformer sit in ``dense`` in the order
    flax names them (``Dense_i`` is ``dense[i]``): use_mlp1's Dense 128 is
    made before its Dense 64."""

    def __init__(self, ocr_rep_dim: int, ocr_num_slots: int, config: PoolingConfigs,
                 num_stacked_obss: int = 1):
        super().__init__()
        d_model = config.d_model
        self.push_embedding = config.push_embedding
        self.cw_embedding = config.cw_embedding
        self.dense = nn.ModuleList()
        in_dim = ocr_rep_dim
        if self.push_embedding or self.cw_embedding:
            self.register_buffer("sin_div", torch.from_numpy(sinusoid_div(d_model)),
                                 persistent=False)
        if self.push_embedding:
            self.embed = nn.ModuleList([_embed(10, 128), _embed(10, 128)])
            self.dense.append(dense(256 + 2 * d_model, 128))
            in_dim = 128
        if self.cw_embedding:
            self.arm_emb = dense(28 * d_model, 128)
            self.obj_emb = dense(3 * d_model + 3, 128)
            in_dim = 128
        first = len(self.dense)
        if config.use_mlp1:
            self.dense.extend([dense(64, 128), dense(in_dim, 64)])
            self._mlp = (first + 1, first)
        elif config.use_mlp2:
            self.dense.extend([dense(in_dim, 64), dense(64, 64), dense(64, 128)])
            self._mlp = (first, first + 1, first + 2)
        else:
            self._mlp = ()
        if self._mlp:
            in_dim = 128
        pos_table = None
        n_tokens = ocr_num_slots * num_stacked_obss + 1
        if num_stacked_obss > 1:
            # per-frame positions, CLS at position 0
            position = np.repeat(np.arange(ocr_num_slots), num_stacked_obss)
            position = np.concatenate([[0], position + 1])
            base = sinusoid_table(int(position.max()) + 1, config.d_model, 0.001)
            pos_table = base[position]
        elif config.pos_emb in ("ape", "lpe"):
            pos_table = sinusoid_table(n_tokens, config.d_model, 0.001)
        self.core = CoreTransformer(in_dim, d_model, config.nhead, config.num_layers,
                                    pos_table)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        if self.push_embedding:
            pos = sinusoid_lookup(state[:, :, -2:], self.sin_div, 10_000_000)
            state = self.dense[0](torch.cat(
                [self.embed[0](state[:, :, 0].to(torch.int32)),
                 self.embed[1](state[:, :, 1].to(torch.int32)), pos[:, :, 0], pos[:, :, 1]],
                dim=-1))
        if self.cw_embedding:
            B, K, _ = state.shape
            arm = self.arm_emb(sinusoid_lookup(state[:, 0, :28], self.sin_div, 10_000)
                               .reshape(B, -1))
            objs = state[:, 1:, 28:]
            obj_pos = sinusoid_lookup(objs[:, :, :3], self.sin_div, 10_000).reshape(B, K - 1, -1)
            obj = self.obj_emb(torch.cat([obj_pos, objs[:, :, 7:10]], dim=-1))
            state = torch.cat([arm[:, None], obj], dim=1)
        for n, i in enumerate(self._mlp):
            state = self.dense[i](state)
            if n < len(self._mlp) - 1:
                state = F.relu(state)
        return self.core(state)


class RN_Module(nn.Module):
    """Relation network (ocrl_tpu/poolings/modules.py:159-180): g over every
    ordered pair (i, j), i != j, in row-major order, of the slots
    concatenated, summed over the pairs, then f; ReLU after every layer.
    ``dense`` holds g's layers, then f's (flax's Dense_0, Dense_1, ...)."""

    def __init__(self, ocr_rep_dim: int, ocr_num_slots: int, config: PoolingConfigs,
                 num_stacked_obss: int = 1):
        super().__init__()
        S = ocr_num_slots * num_stacked_obss
        pairs = torch.tensor([(i, j) for i in range(S) for j in range(S) if i != j],
                             dtype=torch.long).reshape(-1, 2)
        self.register_buffer("pairs", pairs, persistent=False)
        dims = (2 * ocr_rep_dim,) + tuple(config.g_dims) + tuple(config.f_dims)
        self.dense = nn.ModuleList(dense(a, b) for a, b in zip(dims, dims[1:]))
        self.num_g = len(config.g_dims)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        x = torch.cat([state[:, self.pairs[:, 0]], state[:, self.pairs[:, 1]]], dim=-1)
        for layer in self.dense[:self.num_g]:
            x = F.relu(layer(x))
        x = x.sum(1)
        for layer in self.dense[self.num_g:]:
            x = F.relu(layer(x))
        return x


class MLP_Module(nn.Module):
    """The slots flattened, through an MLP (ocrl_tpu/poolings/modules.py:183-195);
    a one-slot OCR's [B, D] as it is."""

    def __init__(self, ocr_rep_dim: int, ocr_num_slots: int, config: PoolingConfigs,
                 num_stacked_obss: int = 1):
        super().__init__()
        self.mlp = MLP(ocr_rep_dim * ocr_num_slots * num_stacked_obss, config.dims,
                       config.acts)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return self.mlp(state.reshape(state.shape[0], -1))


class CNN_Linear_Module(nn.Module):
    """slots -> square image -> the Nature CNN (``models.naturecnn``) ->
    vector (ocrl_tpu/poolings/modules.py:216-227)."""

    def __init__(self, ocr_rep_dim: int, ocr_num_slots: int, config: PoolingConfigs,
                 num_stacked_obss: int = 1):
        super().__init__()
        self.cnn = NatureCNN(ocr_rep_dim, int(round(ocr_num_slots ** 0.5)), config.rep_dim)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return self.cnn(slot_to_img(state))


class CNN_Transformer_Module(nn.Module):
    """slots -> square image -> the Nature CNN's feature map as tokens -> CLS
    transformer (ocrl_tpu/poolings/modules.py:230-249). As in JAX, the
    position table is built for ``ocr_num_slots + 1`` rows and cut to the
    CNN's token count."""

    def __init__(self, ocr_rep_dim: int, ocr_num_slots: int, config: PoolingConfigs,
                 num_stacked_obss: int = 1):
        super().__init__()
        self.cnn = NatureCNN(ocr_rep_dim, int(round(ocr_num_slots ** 0.5)), None)
        pos_table = None
        if config.pos_emb in ("ape", "lpe"):
            pos_table = sinusoid_table(ocr_num_slots + 1, config.d_model, 0.001)
        self.core = CoreTransformer(64, config.d_model, config.nhead, config.num_layers,
                                    pos_table)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        feat = self.cnn(slot_to_img(state))
        return self.core(feat.reshape(feat.shape[0], -1, feat.shape[-1]))


class Identity_Module(nn.Module):
    """The slots flattened; a one-slot OCR's [B, D] as it is
    (ocrl_tpu/poolings/modules.py:252-264)."""

    def __init__(self, ocr_rep_dim: int, ocr_num_slots: int, config: PoolingConfigs,
                 num_stacked_obss: int = 1):
        super().__init__()

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return state.reshape(state.shape[0], -1)


_MODULES = {
    "Transformer": Transformer_Module,
    "RN": RN_Module,
    "MLP": MLP_Module,
    "CNN_Linear": CNN_Linear_Module,
    "CNN_Transformer": CNN_Transformer_Module,
    "Identity": Identity_Module,
}


def pooled_dim(name: str, config: PoolingConfigs, ocr_rep_dim: int, ocr_num_slots: int,
               num_stacked_obss: int = 1) -> int:
    """Output feature size of a pooling (ocrl_tpu/poolings/modules.py:276-291)."""
    if name in ("Transformer", "CNN_Transformer"):
        return config.d_model
    if name == "RN":
        return config.f_dims[-1]
    if name == "MLP":
        return config.dims[-1]
    if name == "CNN_Linear":
        return config.rep_dim
    if name == "Identity":
        return ocr_rep_dim * ocr_num_slots * num_stacked_obss
    raise ValueError(f"Unknown pooling '{name}'")


def create_pooling_module(name: str, ocr_rep_dim: int, ocr_num_slots: int,
                          config: PoolingConfigs, num_stacked_obss: int = 1) -> nn.Module:
    """The pooling ``name`` over ``ocr_num_slots`` slots of ``ocr_rep_dim``
    (ocrl_tpu/poolings/modules.py:294-300)."""
    if name not in _MODULES:
        raise ValueError(f"Unknown pooling '{name}'. Available: {sorted(_MODULES)}")
    return _MODULES[name](ocr_rep_dim, ocr_num_slots, config, num_stacked_obss)
