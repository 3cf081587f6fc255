"""The ``slate`` configuration: what the program is told, the model's FLOPs,
and its plain reference (``benchref.ocr``)."""

from __future__ import annotations

from benchcore.counts import conv_flops, linear_flops, train_flops as _train
from benchref.ocr import _DVAE_DECODER, Trainer, param_spec  # noqa: F401

# configuration key -> the port's override key
PORT_KEYS = {
    "vocab_size": "ocr.dvae.vocab_size", "d_model": "ocr.dvae.d_model",
    "cnn_hidden_size": "ocr.cnn.hidden_size", "num_iterations": "ocr.slotattr.num_iterations",
    "num_slots": "ocr.slotattr.num_slots", "num_slot_heads": "ocr.slotattr.num_slot_heads",
    "slot_size": "ocr.slotattr.slot_size", "mlp_hidden_size": "ocr.slotattr.mlp_hidden_size",
    "fused": "ocr.slotattr.fused", "num_dec_blocks": "ocr.tfdec.num_dec_blocks",
    "num_dec_heads": "ocr.tfdec.num_dec_heads", "use_bcdec": "ocr.use_bcdec",
    "hard": "ocr.hard", "tau_start": "ocr.tau_start", "tau_final": "ocr.tau_final",
    "tau_steps": "ocr.tau_steps", "dropout": "ocr.learning.dropout",
    "clip": "ocr.learning.clip", "lr_dvae": "ocr.learning.lr_dvae",
    "lr_enc": "ocr.learning.lr_enc", "lr_dec": "ocr.learning.lr_dec",
    "lr_warmup_steps": "ocr.learning.lr_warmup_steps",
    "lr_half_life": "ocr.learning.lr_half_life",
}


def _value(v) -> str:
    return str(v).lower() if isinstance(v, bool) else str(v)


def overrides(m: dict) -> list[str]:
    """``key=value`` overrides of ``train_ocr``'s config that give the
    program this configuration."""
    return [f"ocr={m['ocr']}"] + [f"{key}={_value(m[name])}" for name, key in PORT_KEYS.items()]


def encoder_forward(m: dict, B: int) -> list[tuple[int, bool]]:
    """The CNN encoder and slot attention: (FLOPs, input needs a gradient)."""
    size, C, hid = m["obs_size"], m["obs_channels"], m["cnn_hidden_size"]
    S, D, mlp, it = m["num_slots"], m["slot_size"], m["mlp_hidden_size"], m["num_iterations"]
    N = size * size
    out = [(conv_flops(B, size, size, C, hid, 5), False)]
    out += [(conv_flops(B, size, size, hid, hid, 5), True)] * 3
    out += [(conv_flops(1, size, size, 4, hid, 1), False)]
    out += [(linear_flops(B * N, hid, hid), True)] * 2
    out += [(linear_flops(B * N, hid, D), True)] * 2
    per_iteration = [(linear_flops(B * S, D, D), True), (2 * B * N * S * D, True),
                     (2 * B * N * S * D, True), (linear_flops(B * S, D, 3 * D), True),
                     (linear_flops(B * S, D, 3 * D), True), (linear_flops(B * S, D, mlp), True),
                     (linear_flops(B * S, mlp, D), True)]
    return out + per_iteration * it


def decoder_forward(m: dict, B: int) -> list[tuple[int, bool]]:
    """The dVAE and the transformer decoder."""
    size, C, V, d = m["obs_size"], m["obs_channels"], m["vocab_size"], m["d_model"]
    S, D, L = m["num_slots"], m["slot_size"], m["num_dec_blocks"]
    h, T = size // 4, (size // 4) ** 2
    out = [(conv_flops(B, h, h, C, 64, 4), False)]
    out += [(conv_flops(B, h, h, 64, 64, 1), True)] * 6
    out += [(conv_flops(B, h, h, 64, V, 1), True)]
    side = h
    for i, (cin, cout, k) in enumerate(_DVAE_DECODER(V, 64)):
        out.append((conv_flops(B, side, side, cin, cout, k), True))
        if i in (4, 8):
            side *= 2
    out.append((conv_flops(B, size, size, 64, C, 1), True))
    out.append((linear_flops(B * S, D, d), True))
    block = [(linear_flops(B * T, d, d), True)] * 4 + [(2 * B * T * T * d, True)] * 2
    block += [(linear_flops(B * T, d, d), True)] * 2 + [(linear_flops(B * S, d, d), True)] * 2
    block += [(2 * B * T * S * d, True)] * 2
    block += [(linear_flops(B * T, d, 4 * d), True), (linear_flops(B * T, 4 * d, d), True)]
    return out + block * L + [(linear_flops(B * T, d, V), True)]


def train_flops(m: dict, B: int) -> int:
    """Model FLOPs of one training step at batch B, forward and backward."""
    return _train(encoder_forward(m, B) + decoder_forward(m, B))


# -- SAC on the slots (the RL cells) ------------------------------------------------

from benchref.sac import Trainer as SacTrainer, param_spec as sac_param_spec  # noqa: E402,F401

POOLING_KEYS = {"pool_d_model": "pooling.d_model", "pool_nhead": "pooling.nhead",
                "pool_num_layers": "pooling.num_layers",
                "learning_rate": "sb3.algo_kwargs.learning_rate",
                "gamma": "sb3.algo_kwargs.gamma", "tau": "sb3.algo_kwargs.tau",
                "ent_coef": "sb3.algo_kwargs.ent_coef"}


def sac_overrides(m: dict) -> list[str]:
    """``key=value`` overrides of ``train_sb3``'s config for SAC on this
    configuration's slots."""
    ocr = [o for o in overrides(m) if not o.startswith(("ocr.learning.", "ocr.tau_", "ocr.hard"))]
    return ocr + [f"pooling={m['pooling']}", "sb3=sac", f"sb3_acnet={m['acnet']}"] + [
        f"{key}={_value(m[name])}" for name, key in POOLING_KEYS.items()]


def pooling_forward(m: dict, B: int) -> list[tuple[int, bool]]:
    S, D, d = m["num_slots"], m["slot_size"], m["pool_d_model"]
    ff, L = m["pool_feedforward"], S + 1
    layer = [(linear_flops(B * L, d, d), True)] * 4 + [(2 * B * L * L * d, True)] * 2
    layer += [(linear_flops(B * L, d, ff), True), (linear_flops(B * L, ff, d), True)]
    return [(linear_flops(B * S, D, d), True)] + layer * m["pool_num_layers"]


def head_forward(m: dict, B: int, d_in: int, d_out: int) -> list[tuple[int, bool]]:
    out, dims = [], [d_in] + list(m["net_arch"]) + [d_out]
    for a, b in zip(dims, dims[1:]):
        out.append((linear_flops(B, a, b), True))
    return out


def update_flops(m: dict, B: int) -> int:
    """Model FLOPs of one SAC update at batch B: the online and the target
    extractor and heads on the next observations without a graph; the
    extractor and both critics on the observations, forward and backward;
    the actor forward and backward on the detached features, through the
    critics' input gradients."""
    d, A = m["pool_d_model"], m["action_dim"]
    extract = encoder_forward(m, B) + pooling_forward(m, B)
    critic = head_forward(m, B, d + A, 1) * 2
    actor = head_forward(m, B, d, 2 * A)
    no_grad = 2 * sum(f for f, _ in extract) + sum(f for f, _ in actor) + sum(
        f for f, _ in critic)
    critic_pass = _train(extract + critic)
    actor_pass = _train([(f, False) for f, _ in actor[:1]] + actor[1:])
    actor_pass += 2 * sum(f for f, _ in critic)      # forward, then input gradients
    return no_grad + critic_pass + actor_pass
