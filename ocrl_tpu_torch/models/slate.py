"""SLATE (counterpart of ocrl_tpu/models/slate.py): dVAE + slot attention +
autoregressive transformer decoder.

The serving surface (NHWC observations -> CNN + positional features -> slot
attention, slate.py:94-122) is all a policy builds (the default), as the JAX
policy's parameter tree holds only what its forward touches; with
``decoder=True`` the module adds the training surface: the dVAE, the token
dictionary, the transformer decoder and the loss (slate.py:124-231).
``make_optimizer`` builds the three Adam groups (slate.py:270-303).

Random draws come from one explicit generator, in the JAX order: the soft
sample's field (kernel B1), the token ids' field (kernel B2), the initial
slots, then the dropout masks. ``loss`` takes ``noise``, a dict that may
hold the Gumbel fields ``soft`` and ``ids`` ([B*h*w, vocab]) and the slot
noise ``slots`` ([B, S, D]): a field it holds is used instead of a draw, a
field it lacks is drawn and stored into it.

Later slices: ARI with masks and ``gen_imgs`` (evaluation), ``use_bcdec``
training (its broadcast decoder).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import EnvConfig, OCRConfig
from ..ops import gumbel
from .common import PositionalEmbedding, cosine_anneal, linear, linear_warmup
from .dvae import SlotAttnCNNEncoder, dVAE
from .slot_attention import SlotAttentionEncoder
from .transformer import LearnedPositionalEncoding, TransformerDecoder

EVALUATION_SLICE = "the evaluation slice (get_ari_mse)"


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
        if not decoder:
            return
        if ocr.use_bcdec:
            raise NotImplementedError(
                "use_bcdec training (BroadCastDecoder) comes with a later slice")
        enc_size = env.obs_size // 4
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

    def _teacher_forced_ce(self, slots: torch.Tensor, token_ids: torch.Tensor,
                           train: bool, generator: torch.Generator | None = None):
        """Cross-entropy of next-token prediction (slate.py:124-146), the
        target log-probability gathered from the log-softmax."""
        B = token_ids.shape[0]
        z_emb = self.dictionary(token_ids)
        z_emb = torch.cat([self.bos.expand(B, 1, -1), z_emb], dim=1)
        z_emb = self.z_pos(z_emb, train, generator)
        decoded = self.tfdec(z_emb[:, :-1], self.slotproj(slots), train, generator)
        logp = torch.log_softmax(self.out(decoded), dim=-1)
        ce = -logp.gather(-1, token_ids[..., None])[..., 0]
        return ce.sum(-1).mean()

    def loss(self, obs: torch.Tensor, masks: torch.Tensor | None = None,
             step: int = 0, train: bool = False, *,
             generator: torch.Generator | None = None, noise: dict | None = None):
        """(loss, metrics) of one batch obs [B, H, W, C] in [0, 1]
        (slate.py:201-231); see the module docstring for ``noise``."""
        if not self.decoder:
            raise RuntimeError("this SLATE_Module was built without its decoder")
        if masks is not None:
            raise NotImplementedError(f"ARI with masks comes with {EVALUATION_SLICE}")
        ocr = self._ocr
        tau = self.tau(step)
        z_logits = self.dvae.encode_logits(obs)
        B, H, W, V = z_logits.shape
        flat = z_logits.reshape(-1, V).contiguous()
        g, g_out = _field(noise, "soft", flat)
        z = self.dvae.sample(flat, tau, ocr.hard, generator, g, g_out)
        g, g_out = _field(noise, "ids", flat)
        token_ids = gumbel.gumbel_argmax_ids(flat, generator=generator, noise=g,
                                             g_out=g_out).reshape(B, H * W)

        slot_noise = None
        if noise is not None:
            if "slots" not in noise:
                sa = ocr.slotattr
                noise["slots"] = torch.randn((B, sa.num_slots, sa.slot_size),
                                             generator=generator, device=obs.device)
            slot_noise = noise["slots"]
        slots, _ = self.get_slots(obs, slot_noise, generator)

        recon = self.dvae.decode(z.reshape(B, H, W, V))
        dvae_mse = ((obs - recon) ** 2).sum() / B
        ce = self._teacher_forced_ce(slots, token_ids, train, generator)
        loss = dvae_mse + ce
        lr = ocr.learning
        warm = linear_warmup(step, 0.0, 1.0, 0, lr.lr_warmup_steps)
        decay = 2.0 ** (-step / lr.lr_half_life)
        return loss, {"loss": loss, "dvae_mse": dvae_mse, "cross_entropy": ce,
                      "tau": tau, "lr_dvae": lr.lr_dvae,
                      "lr_enc": decay * warm * lr.lr_enc,
                      "lr_dec": decay * warm * lr.lr_dec}

    def gen_imgs(self, slots):
        raise NotImplementedError(f"gen_imgs comes with {EVALUATION_SLICE}")

    def sample_arrays(self, obs):
        raise NotImplementedError(f"sample_arrays comes with {EVALUATION_SLICE}")


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


class MultiGroupAdam:
    """optax.multi_transform of three optax.adam (b1 0.9, b2 0.999, eps
    1e-8): ``dvae`` at a constant lr, ``sa`` and ``dec`` on their schedules.
    The schedules are evaluated here at this optimizer's own count, not
    through an LR scheduler's step."""

    def __init__(self, module: nn.Module, ocr_config: OCRConfig):
        lr = ocr_config.learning
        self.schedules = {
            "dvae": lambda count: lr.lr_dvae,
            "sa": group_schedule(lr.lr_enc, lr.lr_warmup_steps, lr.lr_half_life),
            "dec": group_schedule(lr.lr_dec, lr.lr_warmup_steps, lr.lr_half_life),
        }
        params = {name: [] for name in self.schedules}
        for name, p in module.named_parameters():
            params[GROUP_OF[name.split(".")[0]]].append(p)
        self.adam = torch.optim.Adam(
            [{"params": ps, "group": name} for name, ps in params.items()],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8)
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


def make_optimizer(module: nn.Module, ocr_config: OCRConfig) -> MultiGroupAdam:
    return MultiGroupAdam(module, ocr_config)
