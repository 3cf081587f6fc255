"""Reference-format ``.pth`` OCR checkpoints (counterpart of
ocrl_tpu/utils/torch_convert.py).

The original PyTorch OCRL saves ``{"step", "epoch", "best_val_loss",
"ocr_module_state_dict": <its module's state_dict>, ...}`` with
``torch.save``. This module maps that state dict onto the JAX tree of the
same OCR, with JAX's own name map (``_slate_key``, SLATE only), and sets the
port's module from that tree through ``utils.convert.ocr_from_flax``, the
weight map every parity test of the port holds. The tree's paths and shapes
come from the port itself (``ocr_to_flax`` of the module's state dict).

Layouts translated, as JAX does: a Linear ``weight`` [out, in] is a kernel
[in, out]; a Conv2d ``weight`` [O, I, kh, kw] a kernel [kh, kw, I, O]; a
LayerNorm ``weight`` a ``scale``; a GRUCell's ``weight_ih`` / ``weight_hh``
[3H, D] the fused cell's ``wi`` / ``wh`` [D, 3H]; an Embedding's ``weight``
as it is. Buffers the reference keeps (causal masks, position grids) are
recomputed and skipped.

Kept from JAX on purpose: the errors (``NotImplementedError`` for an OCR
other than SLATE, ``KeyError`` for a JAX path without a reference name or a
reference name missing from the file, ``ValueError`` for a shape
mismatch), among them the ``KeyError`` for the broadcast decoder
(``use_bcdec``): JAX's map still names the decoder's older ``blocks``
layout, which ``migrate_bcdec_tree`` renamed to ``conv1`` / ``rest``, so
JAX cannot load a Slot-Attention ``.pth`` and neither can the port. The
optimizer state is not converted: the OCR keeps the one it was made with.

One difference: the file is read with ``torch.load(..., weights_only=True)``
where JAX passes ``weights_only=False``. A file that holds objects other
than tensors, containers and numbers (a pickled config object, say) is
refused with ``pickle.UnpicklingError`` instead of run as pickled code.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .convert import attention_heads, ocr_from_flax, ocr_to_flax

__all__ = ["convert_ocr_state_dict", "load_reference_checkpoint"]


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


def _linear(x):
    return _t(x).T


def _conv(x):
    return _t(x).transpose(2, 3, 1, 0)


def _ident(x):
    return _t(x)


def _slate_key(path: list[str]) -> tuple[str, Callable] | None:
    """A JAX parameter path -> (reference state-dict key, value transform)
    for SLATE / Slot-Attention (ocrl_tpu/utils/torch_convert.py:50-155)."""
    p = list(path)
    leaf = p[-1]

    def conv_block(torch_prefix: str) -> tuple[str, Callable]:
        # Conv2dBlock/Conv_0.{kernel,bias} <- <prefix>.m.{weight,bias}
        name = "weight" if leaf == "kernel" else "bias"
        return f"{torch_prefix}.m.{name}", (_conv if leaf == "kernel" else _ident)

    def bare_conv(torch_prefix: str) -> tuple[str, Callable]:
        name = "weight" if leaf == "kernel" else "bias"
        return f"{torch_prefix}.{name}", (_conv if leaf == "kernel" else _ident)

    if p[0] == "dvae":
        if p[1] == "encoder":
            i = int(p[2].split("_")[1])
            if len(p) == 5:              # layers_i/Conv_0/{kernel,bias}
                return conv_block(f"_dvae._encoder.{i}")
            return bare_conv(f"_dvae._encoder.{i}")        # layers_7: no .m
        if p[1].startswith("decoder_blocks_"):
            i = int(p[1].split("_")[2])
            return conv_block(f"_dvae._decoder.{i if i < 5 else i + 1}")  # 5, 10: shuffles
        if p[1] == "decoder_out":
            return bare_conv("_dvae._decoder.11")

    if p[0] == "enc":
        if p[1].startswith("Conv2dBlock_"):
            return conv_block(f"_enc._encoder.{int(p[1].split('_')[1])}")
        if p[1] == "Conv_0":
            return bare_conv("_enc._encoder.3")
    if p[0] == "enc_pos" and p[1] == "channels_map":
        return bare_conv("_enc_pos.channels_map")

    if p[0] == "slotattn":
        rest = p[1:]
        if rest in (["slot_mu"], ["slot_log_sigma"]):
            return f"_slotattn.{rest[0]}", _ident
        tk = ".".join(r.replace("layers_", "") for r in rest[:-1])   # mlp/layers_i -> mlp.i
        if "gru" in rest:
            name, tf = {"wi": ("weight_ih", _linear), "wh": ("weight_hh", _linear),
                        "bi": ("bias_ih", _ident), "bh": ("bias_hh", _ident)}[leaf]
            return f"_slotattn.{tk}.{name}", tf
        if leaf == "scale":
            return f"_slotattn.{tk}.weight", _ident
        if leaf == "bias":
            return f"_slotattn.{tk}.bias", _ident
        if leaf == "kernel":
            return f"_slotattn.{tk}.weight", _linear

    # the broadcast decoder: JAX's map knows only the older blocks/layers_i
    # layout, so conv1 / rest fall through to None (see the module docstring)
    if p[0] == "bcdec":
        if p[1] == "blocks":
            i = int(p[2].split("_")[1])
            if len(p) == 5:
                return conv_block(f"_dec._decoder.{i}")
            return bare_conv(f"_dec._decoder.{i}")
        if p[1] == "pos_emb":
            return bare_conv("_dec._pos_emb.channels_map")

    if p[0] == "slotproj":
        return "_slotproj.weight", _linear
    if p[0] == "dictionary":
        return "_dict.dictionary.weight", _ident
    if p[0] == "bos":
        return "_bos_token._bos_token", _ident
    if p[0] == "z_pos":
        return "_z_pos.pe", _ident
    if p[0] == "out":
        return "_out.weight", _linear
    if p[0] == "tfdec":
        if p[1] == "layer_norm":
            return f"_tfdec.layer_norm.{'weight' if leaf == 'scale' else 'bias'}", _ident
        i, sub = int(p[1].split("_")[1]), p[2]
        if sub in ("self_attn", "encoder_decoder_attn"):
            return f"_tfdec.blocks.{i}.{sub}.{p[3]}.weight", _linear
        if sub in ("self_attn_layer_norm", "encoder_decoder_attn_layer_norm", "ffn_layer_norm"):
            return f"_tfdec.blocks.{i}.{sub}.{'weight' if leaf == 'scale' else 'bias'}", _ident
        if sub == "ffn":
            j = {"Dense_0": 0, "Dense_1": 2}[p[3]]
            name = "weight" if leaf == "kernel" else "bias"
            return f"_tfdec.blocks.{i}.ffn.{j}.{name}", (_linear if leaf == "kernel" else _ident)

    return None


_KEY_MAPS: dict[str, Callable] = {"SLATE": _slate_key}


def convert_ocr_state_dict(state_dict: dict, template: dict, model_name: str = "SLATE") -> dict:
    """Map a reference ``ocr_module_state_dict`` onto ``template``, the JAX
    tree of the same architecture (nested dicts of arrays), walked in JAX's
    order (sorted keys), so a file missing several names fails on the
    same one in both. Raises as the module docstring says."""
    key_fn = _KEY_MAPS.get(model_name)
    if key_fn is None:
        raise NotImplementedError(f"torch->flax conversion implemented for "
                                  f"{sorted(_KEY_MAPS)}, not {model_name!r}")

    def convert(tree: dict, path: tuple) -> dict:
        out = {}
        for key in sorted(tree):
            segs = path + (key,)
            if isinstance(tree[key], dict):
                out[key] = convert(tree[key], segs)
                continue
            mapped = key_fn(list(segs))
            if mapped is None:
                raise KeyError(f"no torch mapping for flax param {'/'.join(segs)}")
            tkey, tf = mapped
            if tkey not in state_dict:
                raise KeyError(f"{tkey} (for {'/'.join(segs)}) missing from torch state_dict")
            arr = tf(state_dict[tkey])
            leaf = np.asarray(tree[key])
            if arr.shape != leaf.shape:
                raise ValueError(f"shape mismatch for {'/'.join(segs)} <- {tkey}: "
                                 f"{arr.shape} vs {leaf.shape}")
            out[key] = arr.astype(leaf.dtype)
        return out

    return convert(template, ())


def load_reference_checkpoint(path: str | Path, ocr) -> dict[str, Any]:
    """Set ``ocr``'s module from a reference-format ``.pth`` file in place;
    returns its bookkeeping ({step, epoch, best_val_loss} where present).
    The optimizer state stays as the OCR was made (the reference's torch
    Adam state is not optax's tree, in JAX either)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    template = ocr_to_flax(ocr.module.state_dict(), attention_heads(ocr.module))
    tree = convert_ocr_state_dict(ckpt["ocr_module_state_dict"], template, ocr.name)
    state = ocr.module.state_dict()
    state.update(ocr_from_flax(tree))
    ocr.module.load_state_dict(state)
    return {k: ckpt[k] for k in ("step", "epoch", "best_val_loss") if k in ckpt}
