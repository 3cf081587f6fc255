"""SLATE (counterpart of ocrl_tpu/models/slate.py): dVAE + slot attention +
autoregressive transformer decoder.

The serving surface (NHWC observations -> CNN + positional features -> slot
attention, slate.py:94-122) is all a policy builds (the default), as the JAX
policy's parameter tree holds only what its forward touches; with
``decoder=True`` the module adds the training and evaluation surface: the
dVAE, the token dictionary, the transformer decoder, with ``use_bcdec`` the
broadcast decoder, the loss with its foreground ARI when given masks, and
greedy generation (slate.py:124-256). ``make_optimizer`` builds the three
Adam groups (slate.py:270-303).

Random draws come from one explicit generator, in the JAX order: the soft
sample's field (kernel B1), the token ids' field (kernel B2), the initial
slots, then the dropout masks. ``loss`` takes ``noise``, a dict that may
hold the Gumbel fields ``soft`` and ``ids`` ([B*h*w, vocab]) and the slot
noise ``slots`` ([B, S, D]): a field it holds is used instead of a draw, a
field it lacks is drawn and stored into it. With ``use_bcdec`` the loss is
the broadcast decoder's MSE, which reads neither the dVAE sample nor the
token ids (slate.py:213-217): that branch computes neither and draws only
the slot noise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EnvConfig, OCRConfig
from ..ops import gumbel
from ..utils.metrics import calculate_ari
from ..utils.viz import for_viz, visualize
from .base import MultiGroupAdam, constant
from .common import (PositionalEmbedding, cosine_anneal, gumbel_draw, linear, linear_warmup,
                     randn)
from .dvae import BroadCastDecoder, SlotAttnCNNEncoder, dVAE
from .slot_attention import SlotAttentionEncoder
from .transformer import LearnedPositionalEncoding, TransformerDecoder


def _field(noise: dict | None, key: str, like: torch.Tensor):
    """(the given field or None, a buffer to record the drawn one or None)."""
    if noise is None:
        return None, None
    if key in noise:
        return noise[key], None
    noise[key] = torch.empty_like(like)
    return None, noise[key]


class SLATE_Module(nn.Module):
    def __init__(self, ocr_config: OCRConfig, env_config: EnvConfig, *,
                 decoder: bool = False):
        super().__init__()
        ocr, env = ocr_config, env_config
        self._ocr = ocr
        self._obs_size = env.obs_size
        self._use_cnn_feat = ocr.use_cnn_feat
        self.enc = SlotAttnCNNEncoder(ocr.cnn.hidden_size, env.obs_channels)
        self.enc_pos = PositionalEmbedding(env.obs_size, ocr.cnn.hidden_size)
        sa = ocr.slotattr
        self.slotattn = SlotAttentionEncoder(
            num_iterations=sa.num_iterations, num_slots=sa.num_slots,
            input_channels=ocr.cnn.hidden_size, slot_size=sa.slot_size,
            mlp_hidden_size=sa.mlp_hidden_size, num_heads=sa.num_slot_heads,
            fused=sa.fused)
        V, d = ocr.dvae.vocab_size, ocr.dvae.d_model
        # a parameter of SLATE itself, so JAX creates it with any method
        # (serving too): the policy's tree holds it
        bound = math.sqrt(6.0 / (1 + d))    # xavier_uniform of a (1, 1, d) param
        self.bos = nn.Parameter(torch.empty(1, 1, d).uniform_(-bound, bound))
        self.decoder = decoder
        self.use_bcdec = ocr.use_bcdec
        if not decoder:
            return
        if ocr.use_bcdec:
            self.bcdec = BroadCastDecoder(env.obs_size, env.obs_channels,
                                          ocr.cnn.hidden_size, sa.slot_size)
        self._enc_size = enc_size = env.obs_size // 4
        rate = ocr.learning.dropout
        self.dvae = dVAE(V, env.obs_channels)
        self.slotproj = linear(sa.slot_size, d, bias=False)
        self.dictionary = nn.Embedding(V, d)
        nn.init.normal_(self.dictionary.weight, std=d ** -0.5)   # flax nn.Embed
        self.z_pos = LearnedPositionalEncoding(1 + enc_size ** 2, d, rate)
        self.tfdec = TransformerDecoder(ocr.tfdec.num_dec_blocks, enc_size ** 2, d,
                                        ocr.tfdec.num_dec_heads, rate)
        self.out = linear(d, V, bias=False)

    # -- serving surface -----------------------------------------------------

    def _emb(self, obs: torch.Tensor) -> torch.Tensor:
        """CNN + positional features as tokens [B, H*W, C], row-major over
        (H, W)."""
        feat = self.enc_pos(self.enc(obs))
        B, H, W, C = feat.shape
        return feat.reshape(B, H * W, C)

    def get_slots(self, obs: torch.Tensor, noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """obs [B, H, W, C] in [0, 1] -> (slots [B, S, D], attns [B, H*W, S])."""
        return self.slotattn(self._emb(obs), noise=noise, generator=generator)

    def noise_shape(self, B: int) -> tuple[int, ...] | None:
        """The shape of ``forward``'s ``noise`` for B observations (the
        initial slots' standard normals), None where it draws nothing."""
        sa = self._ocr.slotattr
        return None if self._use_cnn_feat else (B, sa.num_slots, sa.slot_size)

    def forward(self, obs: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self._use_cnn_feat:
            x = torch.cat([self.enc_pos(self.enc(obs)), obs], dim=-1)
            return x.reshape(x.shape[0], -1, x.shape[-1])
        slots, _ = self.get_slots(obs, noise, generator)
        return slots

    def forward_with_attns(self, obs: torch.Tensor, as_masks: bool = False,
                           noise: torch.Tensor | None = None,
                           generator: torch.Generator | None = None):
        """(slots, attentions as images [B, S, H, W, 1], or blended with the
        observation [B, S, H, W, C] unless ``as_masks``)."""
        slots, attns = self.get_slots(obs, noise, generator)
        B, HW, S = attns.shape
        H = W = self._obs_size
        attns_img = attns.transpose(1, 2).reshape(B, S, H, W, 1)
        if as_masks:
            return slots, attns_img
        return slots, obs[:, None] * attns_img + (1.0 - attns_img)

    # -- training surface ----------------------------------------------------

    def tau(self, step: int) -> float:
        ocr = self._ocr
        return cosine_anneal(step, ocr.tau_start, ocr.tau_final, 0, ocr.tau_steps)

    def teacher_forced_logits(self, slots: torch.Tensor, token_ids: torch.Tensor,
                              train: bool = False,
                              generator: torch.Generator | None = None) -> torch.Tensor:
        """Next-token logits [B, T, vocab] of the decoder fed ``bos`` and the
        tokens [B, T] before each position (slate.py:131-138)."""
        B = token_ids.shape[0]
        z_emb = self.dictionary(token_ids)
        z_emb = torch.cat([self.bos.expand(B, 1, -1), z_emb], dim=1)
        z_emb = self.z_pos(z_emb, train, generator)
        decoded = self.tfdec(z_emb[:, :-1], self.slotproj(slots), train, generator)
        return self.out(decoded)

    def _teacher_forced_ce(self, slots: torch.Tensor, token_ids: torch.Tensor,
                           train: bool, generator: torch.Generator | None = None):
        """Cross-entropy of next-token prediction (slate.py:124-146), the
        target log-probability gathered from the log-softmax."""
        logp = torch.log_softmax(
            self.teacher_forced_logits(slots, token_ids, train, generator), dim=-1)
        ce = -logp.gather(-1, token_ids[..., None])[..., 0]
        return ce.sum(-1).mean()

    @torch.no_grad()
    def gen_tokens(self, slots: torch.Tensor) -> torch.Tensor:
        """Greedy decode of the h*w tokens [B, T] with K/V caches
        (slate.py:148-169), one eager step a token where JAX scans."""
        B = slots.shape[0]
        cross_ks, cross_vs = self.tfdec.cross_kvs(self.slotproj(slots))
        k_caches, v_caches = self.tfdec.make_caches(B, slots.device, slots.dtype)
        T = self._enc_size ** 2
        tokens = torch.empty(B, T, dtype=torch.long, device=slots.device)
        emb = self.bos[0].expand(B, -1)
        for t in range(T):
            out_t = self.tfdec.step(emb + self.z_pos.slice_at(t), k_caches, v_caches,
                                    t, cross_ks, cross_vs)
            tokens[:, t] = torch.argmax(self.out(out_t), dim=-1)
            emb = self.dictionary(tokens[:, t])
        return tokens

    @torch.no_grad()
    def gen_imgs(self, slots: torch.Tensor) -> torch.Tensor:
        """Greedy tokens decoded as one-hot codes by the dVAE: images
        [B, H, W, C] (slate.py:171-176)."""
        tokens = self.gen_tokens(slots)
        V, h = self.dictionary.num_embeddings, self._enc_size
        z = F.one_hot(tokens, V).to(slots.dtype).reshape(slots.shape[0], h, h, V)
        return self.dvae.decode(z)

    def ari_pred_masks(self, attns: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """The predicted masks [B, S + 1, H, W, 1] that the foreground ARI
        scores against ``masks`` [B, K, H, W, 1] (background last): the
        attentions times the foreground, then the foreground itself
        (slate.py:182-186)."""
        B, HW, S = attns.shape
        H = W = self._obs_size
        attns_img = attns.transpose(1, 2).reshape(B, S, H, W, 1)
        fg = 1.0 - masks[:, -1:]
        return torch.cat([attns_img * fg, fg], dim=1)

    def _ari(self, attns: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Foreground-masked ARI, the batch mean (slate.py:178-187)."""
        return calculate_ari(masks, self.ari_pred_masks(attns, masks)).mean()

    def loss(self, obs: torch.Tensor, masks: torch.Tensor | None = None,
             step: int = 0, train: bool = False, *,
             generator: torch.Generator | None = None, noise: dict | None = None):
        """(loss, metrics) of one batch obs [B, H, W, C] in [0, 1]
        (slate.py:201-231); see the module docstring for ``noise``."""
        if not self.decoder:
            raise RuntimeError("this SLATE_Module was built without its decoder")
        ocr = self._ocr
        if self.use_bcdec:
            slots, attns = self.get_slots(obs, self._slot_noise(obs, generator, noise),
                                          generator)
            metrics = {} if masks is None else {"ari": self._ari(attns, masks)}
            mse = ((obs - self.bcdec(slots)) ** 2).sum() / obs.shape[0]
            metrics.update({"loss": mse, "mse": mse})
            return mse, metrics
        tau = self.tau(step)
        z_logits = self.dvae.encode_logits(obs)
        B, H, W, V = z_logits.shape
        flat = z_logits.reshape(-1, V).contiguous()
        g, g_out = _field(noise, "soft", flat)
        z = self.dvae.sample(flat, tau, ocr.hard, generator, g, g_out)
        g, g_out = _field(noise, "ids", flat)
        g, row0 = gumbel_draw(flat, generator, g)
        token_ids = gumbel.gumbel_argmax_ids(flat, generator=generator, noise=g, g_out=g_out,
                                             row0=row0).reshape(B, H * W)

        slots, attns = self.get_slots(obs, self._slot_noise(obs, generator, noise),
                                      generator)
        metrics = {} if masks is None else {"ari": self._ari(attns, masks)}

        recon = self.dvae.decode(z.reshape(B, H, W, V))
        dvae_mse = ((obs - recon) ** 2).sum() / B
        ce = self._teacher_forced_ce(slots, token_ids, train, generator)
        loss = dvae_mse + ce
        lr = ocr.learning
        warm = linear_warmup(step, 0.0, 1.0, 0, lr.lr_warmup_steps)
        decay = 2.0 ** (-step / lr.lr_half_life)
        metrics.update({"loss": loss, "dvae_mse": dvae_mse, "cross_entropy": ce,
                        "tau": tau, "lr_dvae": lr.lr_dvae,
                        "lr_enc": decay * warm * lr.lr_enc,
                        "lr_dec": decay * warm * lr.lr_dec})
        return loss, metrics

    def _slot_noise(self, obs: torch.Tensor, generator: torch.Generator | None,
                    noise: dict | None) -> torch.Tensor | None:
        """The initial slots' noise held in ``noise``, drawn into it when it
        lacks one; None (drawn by the encoder) without a dict."""
        if noise is None:
            return None
        if "slots" not in noise:
            sa = self._ocr.slotattr
            noise["slots"] = randn((obs.shape[0], sa.num_slots, sa.slot_size), generator,
                                   obs.device)
        return noise["slots"]

    @torch.no_grad()
    def sample_arrays(self, obs: torch.Tensor, generator: torch.Generator | None = None):
        """The arrays of a sample grid (slate.py:246-256): (obs, the
        broadcast decoder's image, the attentions blended with obs), or
        (obs, the dVAE reconstruction at tau_start, the generated image,
        the blend). The grid itself is drawn on the host by the logger."""
        if self.use_bcdec:
            slots, attns_vis = self.forward_with_attns(obs, generator=generator)
            return obs, self.bcdec(slots), attns_vis
        z, _ = self.dvae(obs, self.tau(0), self._ocr.hard, generator)
        slots, attns_vis = self.forward_with_attns(obs, generator=generator)
        return obs, self.dvae.decode(z), self.gen_imgs(slots), attns_vis

    @staticmethod
    def samples_grid(*arrays) -> dict:
        """The sample arrays side by side along the width, uint8 (slate.py:258-260)."""
        return {"samples": for_viz(visualize(list(arrays)))}


def dims(ocr_config: OCRConfig, env_config: EnvConfig) -> tuple[int, int]:
    """(representation size, number of slots) of the OCR's output."""
    if ocr_config.use_cnn_feat:
        return (ocr_config.cnn.hidden_size + env_config.obs_channels,
                env_config.obs_size ** 2)
    return ocr_config.slotattr.slot_size, ocr_config.slotattr.num_slots


# -- optimizer (slate.py:270-303) ---------------------------------------------

GROUP_OF = {
    "dvae": "dvae",
    "enc": "sa", "enc_pos": "sa", "slotattn": "sa", "slotproj": "sa", "bcdec": "sa",
    "dictionary": "dec", "bos": "dec", "z_pos": "dec", "tfdec": "dec", "out": "dec",
}


def group_schedule(base_lr: float, warmup_steps: int, half_life: int):
    """lr at optax's ``count`` (0 at the first update):
    base * linear_warmup(count) * 2^(-count / half_life)."""
    def schedule(count: int) -> float:
        return (base_lr * linear_warmup(count, 0.0, 1.0, 0, warmup_steps)
                * 2.0 ** (-count / half_life))
    return schedule


def make_optimizer(module: nn.Module, ocr_config: OCRConfig) -> MultiGroupAdam:
    """optax.multi_transform of three optax.adam (b1 0.9, b2 0.999, eps
    1e-8): ``dvae`` at a constant lr, ``sa`` and ``dec`` on their
    schedules."""
    lr = ocr_config.learning
    schedules = {
        "dvae": constant(lr.lr_dvae),
        "sa": group_schedule(lr.lr_enc, lr.lr_warmup_steps, lr.lr_half_life),
        "dec": group_schedule(lr.lr_dec, lr.lr_warmup_steps, lr.lr_half_life),
    }
    params = {name: [] for name in schedules}
    for name, p in module.named_parameters():
        params[GROUP_OF[name.split(".")[0]]].append(p)
    return MultiGroupAdam({name: (params[name], schedule, 0.0)
                           for name, schedule in schedules.items()})
