"""Carry a JAX policy's parameters into the port.

``from_flax(params)`` takes the parameter tree of an ``ActorCriticPolicy``
built by the JAX package (nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, algo.params)`` gives them) and returns the port's
``state_dict``. Layouts:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``; conv HWIO -> OIHW;
- LayerNorm ``scale`` -> ``weight``;
- MultiHeadDotProductAttention: q/k/v kernels ``[in, heads, hd]`` ->
  ``[heads*hd, in]``, biases ``[heads, hd]`` -> ``[heads*hd]``, the out kernel
  ``[heads, hd, out]`` -> ``[out, heads*hd]``;
- FusedGRUCell ``wi``/``wh [D, 3D]`` -> ``wi.weight``/``wh.weight [3D, D]``,
  ``bi``/``bh`` -> ``wi.bias``/``wh.bias``;
- Embed ``embedding [V, d]`` -> ``weight [V, d]``;
- a vmapped leaf (MultipleCNN's, stacked on axis 0 over K modules): conv
  kernels ``[K, h, w, I, O]`` -> one grouped OIHW weight ``[K*O, I, h, w]``,
  biases ``[K, O]`` -> ``[K*O]``; the Dense ``[K, in, out]`` ->
  ``[K, out, in]``, its bias ``[K, out]`` as it is;
- flax's OptimizedLSTMCell: the input kernels ``ii/if/ig/io`` -> ``ih``,
  the hidden ones ``hi/hf/hg/ho`` and their biases -> ``hh``, each
  ``[4 * hidden, in]`` in the gate order i, f, g, o;
- every Dense, Conv, LayerNorm and attention leaf of NatureCNN, VAE, MAE,
  IODINE and the poolings by the same rules; a Dense after a convolution
  reads the map flattened as H, W, C in both packages, so its kernel needs
  no permutation;
- ``slot_mu``, ``slot_log_sigma``, ``cls_token``, ``bos``, ``pe``,
  ``mask_token``, ``slot_mean_init`` and ``slot_logsig_init`` as they are.

``ocr_from_flax(params)`` does the same for an OCR's own tree, as
``OCR.params`` of the JAX package holds it (or a checkpoint's
``ocr_module_state_dict``), and returns the ``state_dict`` of the port's
whole OCR module (``models.build_module(..., decoder=True)``): SLATE's with
the broadcast decoder's, the VAE's with ``in_dec`` and ``dec``, MAE's with
its decoder.

A key the port does not build raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_SA = "ocr_module/slotattn/slot_attention"
_LAYER = r"pooling_module/CoreTransformer_0/TorchEncoderLayer_(\d+)"
_DEC = r"ocr_module/tfdec/blocks_(\d+)"
_VIT = r"ocr_module/(blocks|decoder_blocks)_(\d+)"
# (flax module path, port module path); full matches over "/"-joined paths
_MODULES = [
    (r"ocr_module/enc/Conv2dBlock_(\d+)/Conv_0", r"ocr_module.enc.blocks.\1.conv"),
    (r"ocr_module/enc/Conv_0", "ocr_module.enc.out"),
    (r"ocr_module/enc_pos/channels_map", "ocr_module.enc_pos.channels_map"),
    (r"ocr_module", "ocr_module"),
    (r"ocr_module/slotattn", "ocr_module.slotattn"),
    (r"ocr_module/slotattn/layer_norm", "ocr_module.slotattn.layer_norm"),
    (r"ocr_module/slotattn/mlp/layers_(\d+)", r"ocr_module.slotattn.mlp.\1"),
    (_SA + r"/(norm_inputs|norm_slots|norm_mlp|project_q|project_k|project_v|gru)",
     r"ocr_module.slotattn.slot_attention.\1"),
    (_SA + r"/mlp/layers_(\d+)", r"ocr_module.slotattn.slot_attention.mlp.\1"),
    (r"ocr_module/dvae/encoder/layers_(\d+)/Conv_0", r"ocr_module.dvae.encoder.\1.conv"),
    (r"ocr_module/dvae/encoder/layers_(\d+)", r"ocr_module.dvae.encoder.\1"),
    (r"ocr_module/dvae/decoder_blocks_(\d+)/Conv_0",
     r"ocr_module.dvae.decoder_blocks.\1.conv"),
    (r"ocr_module/dvae/decoder_out", "ocr_module.dvae.decoder_out"),
    (r"ocr_module/bcdec/conv1", "ocr_module.bcdec.conv1"),
    (r"ocr_module/bcdec/pos_emb/channels_map", "ocr_module.bcdec.pos_emb.channels_map"),
    (r"ocr_module/bcdec/rest/layers_([01])/Conv_0", r"ocr_module.bcdec.rest.\1.conv"),
    (r"ocr_module/bcdec/rest/layers_2", "ocr_module.bcdec.rest.2"),
    (r"ocr_module/(dictionary|z_pos|slotproj|out)", r"ocr_module.\1"),
    (r"ocr_module/MLP_0/Dense_(\d+)", r"ocr_module.mlp.\1"),           # GT
    # NatureCNN, and MultipleCNN's vmapped NatureCNN (leaves stacked on axis 0)
    (r"ocr_module/(?:VmapNatureCNN_Module_0/)?Conv_(\d+)", r"ocr_module.convs.\1"),
    (r"ocr_module/(?:VmapNatureCNN_Module_0/)?Dense_0", "ocr_module.dense"),
    # VAE
    (r"ocr_module/dec/Conv2dBlock_(\d+)/Conv_0", r"ocr_module.dec.blocks.\1.conv"),
    (r"ocr_module/dec/Conv_0", "ocr_module.dec.out"),
    (r"ocr_module/(mu|var|in_dec)", r"ocr_module.\1"),
    # MAE
    (r"ocr_module/(patch_embed|encoder_norm|decoder_embed|decoder_norm|decoder_pred)",
     r"ocr_module.\1"),
    (_VIT + r"/LayerNorm_0", r"ocr_module.\1.\2.norm1"),
    (_VIT + r"/LayerNorm_1", r"ocr_module.\1.\2.norm2"),
    (_VIT + r"/MultiHeadDotProductAttention_0/(query|key|value|out)",
     r"ocr_module.\1.\2.attn.\3"),
    (_VIT + r"/Dense_0", r"ocr_module.\1.\2.fc1"),
    (_VIT + r"/Dense_1", r"ocr_module.\1.\2.fc2"),
    # IODINE
    (r"ocr_module/decoder/Conv_0", "ocr_module.decoder.conv1"),
    (r"ocr_module/decoder/Conv_1", "ocr_module.decoder.conv_out"),
    (r"ocr_module/decoder/MultiLayerConv_0/Conv_(\d+)", r"ocr_module.decoder.mlc.\1"),
    (r"ocr_module/refine/mlc/Conv_(\d+)", r"ocr_module.refine.mlc.\1"),
    (r"ocr_module/refine/(mlp|mean_update|logsig_update)", r"ocr_module.refine.\1"),
    (r"ocr_module/refine/lstm/([ih][ifgo])", r"ocr_module.refine.lstm.\1"),
    (_DEC + r"/(self_attn|encoder_decoder_attn)/(proj_[qkvo])",
     r"ocr_module.tfdec.blocks.\1.\2.\3"),
    (_DEC + r"/(self_attn_layer_norm|encoder_decoder_attn_layer_norm|ffn_layer_norm)",
     r"ocr_module.tfdec.blocks.\1.\2"),
    (_DEC + r"/ffn/Dense_0", r"ocr_module.tfdec.blocks.\1.ffn.fc1"),
    (_DEC + r"/ffn/Dense_1", r"ocr_module.tfdec.blocks.\1.ffn.fc2"),
    (r"ocr_module/tfdec/layer_norm", "ocr_module.tfdec.layer_norm"),
    (r"pooling_module/CoreTransformer_0", "pooling_module.core"),
    (r"pooling_module/Dense_(\d+)", r"pooling_module.dense.\1"),
    (r"pooling_module/Embed_(\d+)", r"pooling_module.embed.\1"),
    (r"pooling_module/(arm_emb|obj_emb)", r"pooling_module.\1"),
    (r"pooling_module/MLP_0/Dense_(\d+)", r"pooling_module.mlp.\1"),
    (r"pooling_module/PoolNatureCNN_0/Conv_(\d+)", r"pooling_module.cnn.convs.\1"),
    (r"pooling_module/PoolNatureCNN_0/Dense_0", "pooling_module.cnn.dense"),
    (r"pooling_module/CoreTransformer_0/Dense_0", "pooling_module.core.proj"),
    (_LAYER + r"/MultiHeadDotProductAttention_0/(query|key|value|out)",
     r"pooling_module.core.layers.\1.attn.\2"),
    (_LAYER + r"/LayerNorm_0", r"pooling_module.core.layers.\1.norm1"),
    (_LAYER + r"/LayerNorm_1", r"pooling_module.core.layers.\1.norm2"),
    (_LAYER + r"/Dense_0", r"pooling_module.core.layers.\1.linear1"),
    (_LAYER + r"/Dense_1", r"pooling_module.core.layers.\1.linear2"),
    (r"acnet/(shared|policy|value)_(\d+)", r"acnet.\1.\2"),
    (r"(action_net|value_net_out)", r"\1"),
    (r"(actor|q1|q2)_(\d+|out)", r"\1_\2"),                            # SAC's heads
    (r"head/Dense_(\d+)", r"head.dense.\1"),               # the probes' Dense stacks
]
_KEPT = ("slot_mu", "slot_log_sigma", "cls_token", "bos", "pe", "mask_token",
         "slot_mean_init", "slot_logsig_init")
# flax OptimizedLSTMCell kernels, in the order of the port's packed gates
_GATES = ("i", "f", "g", "o")


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module(path: str) -> str:
    for pattern, repl in _MODULES:
        if re.fullmatch(pattern, path):
            return re.sub(pattern, repl, path)
    raise KeyError(path)


def _leaf(module: str, name: str, x: np.ndarray) -> tuple[str, np.ndarray]:
    stacked_dense = module == "ocr_module.dense" and x.ndim == (3 if name == "kernel" else 2)
    if name == "kernel":
        if x.ndim == 5:                # K stacked HWIO -> K blocks of O, grouped OIHW
            K, h, w, i, o = x.shape
            return "weight", x.transpose(0, 4, 3, 1, 2).reshape(K * o, i, h, w)
        if x.ndim == 4:                                   # HWIO -> OIHW
            return "weight", x.transpose(3, 2, 0, 1)
        if stacked_dense:                                 # [K, in, out] -> [K, out, in]
            return "weight", x.transpose(0, 2, 1)
        if x.ndim == 3 and module.endswith(".attn.out"):  # [H, hd, out]
            return "weight", x.reshape(-1, x.shape[-1]).T
        if x.ndim == 3:                                   # [in, H, hd]
            return "weight", x.reshape(x.shape[0], -1).T
        return "weight", x.T
    if name == "bias":
        return "bias", x if stacked_dense else x.reshape(-1)
    if name in ("scale", "embedding"):
        return "weight", x
    if name in ("wi", "wh"):
        return f"{name}.weight", x.T
    if name in ("bi", "bh"):
        return ("wi" if name == "bi" else "wh") + ".bias", x
    if name in _KEPT:
        return name, x
    raise KeyError(f"{module}/{name}")


def from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX policy's parameter tree -> the port policy's ``state_dict``."""
    state = {}
    for path, value in _flatten(params):
        try:
            module = _module("/".join(path[:-1]))
            name, x = _leaf(module, path[-1], np.asarray(value, np.float32))
        except KeyError:
            raise KeyError(f"no port counterpart for flax parameter "
                           f"'{'/'.join(path)}'") from None
        state[f"{module}.{name}"] = torch.from_numpy(np.array(x, order="C"))
    return _pack_lstm(state)


def _pack_lstm(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """flax's per-gate LSTM kernels (``ii`` ... ``io`` without bias, ``hi``
    ... ``ho`` with one) -> the port's ``ih`` and ``hh``, gates i, f, g, o."""
    for key in [k for k in state if k.endswith(".lstm.ii.weight")]:
        lstm = key[:-len(".ii.weight")]
        for side, names in (("ih", ("weight",)), ("hh", ("weight", "bias"))):
            for name in names:
                parts = [state.pop(f"{lstm}.{side[0]}{g}.{name}") for g in _GATES]
                state[f"{lstm}.{side}.{name}"] = torch.cat(parts)
    return state


def ocr_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX OCR's parameter tree (``OCR.params``) -> the port OCR module's
    ``state_dict``."""
    prefix = "ocr_module."
    return {k[len(prefix):]: v for k, v in from_flax({"ocr_module": params}).items()}


# -- the way back: the port's OCR to JAX's tree --------------------------------

# (port module path, flax module path) of an OCR's tree, full matches; a path
# no rule names maps its dots to slashes
_TO_FLAX = [
    (r"(enc|dec)\.blocks\.(\d+)\.conv", r"\1/Conv2dBlock_\2/Conv_0"),
    (r"(enc|dec)\.out", r"\1/Conv_0"),
    (r"slotattn\.(slot_attention\.)?mlp\.(\d+)",
     lambda m: f"slotattn/{'slot_attention/' if m[1] else ''}mlp/layers_{m[2]}"),
    (r"dvae\.encoder\.(\d+)\.conv", r"dvae/encoder/layers_\1/Conv_0"),
    (r"dvae\.encoder\.(\d+)", r"dvae/encoder/layers_\1"),
    (r"dvae\.decoder_blocks\.(\d+)\.conv", r"dvae/decoder_blocks_\1/Conv_0"),
    (r"bcdec\.rest\.([01])\.conv", r"bcdec/rest/layers_\1/Conv_0"),
    (r"bcdec\.rest\.2", "bcdec/rest/layers_2"),
    (r"mlp\.(\d+)", r"MLP_0/Dense_\1"),                                   # GT
    (r"tfdec\.blocks\.(\d+)\.ffn\.fc([12])",
     lambda m: f"tfdec/blocks_{m[1]}/ffn/Dense_{int(m[2]) - 1}"),
    (r"tfdec\.blocks\.(\d+)\.(.+)", lambda m: f"tfdec/blocks_{m[1]}/{m[2].replace('.', '/')}"),
    (r"(blocks|decoder_blocks)\.(\d+)\.norm([12])",
     lambda m: f"{m[1]}_{m[2]}/LayerNorm_{int(m[3]) - 1}"),
    (r"(blocks|decoder_blocks)\.(\d+)\.attn\.(query|key|value|out)",
     r"\1_\2/MultiHeadDotProductAttention_0/\3"),
    (r"(blocks|decoder_blocks)\.(\d+)\.fc([12])",
     lambda m: f"{m[1]}_{m[2]}/Dense_{int(m[3]) - 1}"),
    (r"decoder\.conv1", "decoder/Conv_0"),
    (r"decoder\.conv_out", "decoder/Conv_1"),
    (r"decoder\.mlc\.(\d+)", r"decoder/MultiLayerConv_0/Conv_\1"),
    (r"refine\.mlc\.(\d+)", r"refine/mlc/Conv_\1"),
]
_VMAP = "VmapNatureCNN_Module_0/"


def _flax_module(module: str, stacked: int | None) -> str:
    if module in ("dense",) or re.fullmatch(r"convs\.(\d+)", module):
        name = "Dense_0" if module == "dense" else f"Conv_{module.split('.')[1]}"
        return (_VMAP if stacked else "") + name
    for pattern, repl in _TO_FLAX:
        if re.fullmatch(pattern, module):
            return re.sub(pattern, repl, module)
    return module.replace(".", "/")


def _flax_leaf(module: str, name: str, x: np.ndarray, heads: int | None,
               stacked: int | None) -> tuple[str, np.ndarray]:
    """The inverse of ``_leaf``: the flax leaf name and array of the port's
    ``module.name``."""
    attn = re.search(r"\.attn\.(query|key|value|out)$", module)
    if attn and heads is None:
        raise KeyError(f"{module}: the number of heads of this attention is not given")
    if name == "weight":
        if module.endswith("dictionary"):
            return "embedding", x
        if x.ndim == 1:
            return "scale", x
        if x.ndim == 4 and stacked and module.startswith("convs."):
            o, i, h, w = x.shape
            return "kernel", x.reshape(stacked, o // stacked, i, h, w).transpose(0, 3, 4, 2, 1)
        if x.ndim == 4:                                   # OIHW -> HWIO
            return "kernel", x.transpose(2, 3, 1, 0)
        if x.ndim == 3:                                   # [K, out, in] -> [K, in, out]
            return "kernel", x.transpose(0, 2, 1)
        if attn and attn[1] == "out":                     # [out, H*hd] -> [H, hd, out]
            return "kernel", x.T.reshape(heads, -1, x.shape[0])
        if attn:                                          # [H*hd, in] -> [in, H, hd]
            return "kernel", x.T.reshape(x.shape[1], heads, -1)
        return "kernel", x.T
    if name == "bias":
        if attn and attn[1] != "out":
            return "bias", x.reshape(heads, -1)
        if stacked and module.startswith("convs."):
            return "bias", x.reshape(stacked, -1)
        return "bias", x
    if name in _KEPT:
        return name, x
    raise KeyError(f"{module}.{name}")


def attention_heads(module: torch.nn.Module) -> dict[str, int]:
    """{module path: heads} of the module's flax-style attention layers
    (MAE's), which ``ocr_to_flax`` needs to split their kernels."""
    return {name: m.num_heads for name, m in module.named_modules()
            if type(m).__name__ == "MultiHeadDotProductAttention"}


def ocr_to_flax(state: dict[str, torch.Tensor], heads: dict[str, int] | None = None) -> dict:
    """The port OCR module's ``state_dict`` -> JAX's tree of the same OCR
    (``OCR.params``), the exact inverse of ``ocr_from_flax``: numpy arrays
    in flax's layouts, the LSTM's gates unpacked, MultipleCNN's grouped
    convolutions re-stacked over its K modules. ``heads`` gives the heads
    of each attention (``attention_heads(module)``)."""
    heads = heads or {}
    state = {k: v.detach().cpu().numpy() for k, v in state.items()}
    for key in [k for k in state if k.endswith(".lstm.ih.weight")]:
        lstm = key[:-len(".ih.weight")]
        for side, names in (("ih", ("weight",)), ("hh", ("weight", "bias"))):
            for name in names:
                for g, part in zip(_GATES, np.split(state.pop(f"{lstm}.{side}.{name}"), 4)):
                    state[f"{lstm}.{side[0]}{g}.{name}"] = part
    dense = state.get("dense.weight")
    stacked = dense.shape[0] if dense is not None and dense.ndim == 3 else None
    tree: dict = {}
    for key, x in state.items():
        module, _, name = key.rpartition(".")
        gru = re.fullmatch(r"(.*\.gru)\.(wi|wh)", module)
        if gru:                                        # FusedGRUCell: wi/wh and bi/bh
            path, leaf = gru[1].replace(".", "/"), \
                gru[2] if name == "weight" else "b" + gru[2][1]
            x = x.T if name == "weight" else x
        else:
            path = _flax_module(module, stacked) if module else ""
            leaf, x = _flax_leaf(module, name, x, heads.get(module.rsplit(".", 1)[0]),
                                 stacked)
        node = tree
        for part in [p for p in path.split("/") if p]:
            node = node.setdefault(part, {})
        node[leaf] = np.array(x, order="C")       # a copy: never a view of a live tensor
    return tree


# -- the optimizer state: MultiGroupAdam <-> optax's state dict ---------------------

# optax's tree around the Adam state(s) of each kind of OCR (flax's
# to_state_dict of ``OCR.opt_state``): the clip of SLATE and IODINE is
# "0": {} before it; SLATE's multi_transform holds one chain per group, whose
# "1" is the schedule's {"count"} where the lr follows one; MAE's adamw adds
# the masked weight decay's {"inner_state": {}}; every chain ends with the
# learning-rate scale, {}.
_SLATE_GROUPS = {"dvae": False, "sa": True, "dec": True}     # group: lr on a schedule


def _mask_like(full, part):
    """``full`` with every leaf ``part`` lacks replaced by {} (optax's
    MaskedNode in a state dict)."""
    if isinstance(full, dict):
        return {k: _mask_like(v, part.get(k, {}) if isinstance(part, dict) else {})
                for k, v in full.items()}
    return part if isinstance(part, np.ndarray) else {}


def _adam_state(ocr, params: list[tuple[str, torch.nn.Parameter]], full) -> dict:
    adam, heads = ocr.optimizer.adam, attention_heads(ocr.module)
    moments = {}
    for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        values = {n: adam.state[p][moment] if moment in adam.state.get(p, {})
                  else torch.zeros_like(p) for n, p in params}
        moments[key] = _mask_like(full, ocr_to_flax(values, heads)) if full is not None \
            else ocr_to_flax(values, heads)
    return {"count": np.asarray(ocr.optimizer.count, np.int32), **moments}


def optax_state(ocr) -> dict:
    """The port OCR's optimizer state as JAX's ``OCR.opt_state`` state dict
    for the same OCR (the tree ``flax.serialization.to_state_dict`` gives)."""
    opt = ocr.optimizer
    named = {id(p): n for n, p in ocr.module.named_parameters()}
    groups = {g["group"]: [(named[id(p)], p) for p in g["params"]]
              for g in opt.adam.param_groups}
    if set(groups) == set(_SLATE_GROUPS):
        full = ocr_to_flax(dict(ocr.module.named_parameters()), attention_heads(ocr.module))
        count = {"count": np.asarray(opt.count, np.int32)}
        inner = {"inner_states": {
            g: {"inner_state": {"0": _adam_state(ocr, groups[g], full),
                                "1": dict(count) if scheduled else {}}}
            for g, scheduled in _SLATE_GROUPS.items()}}
    elif set(groups) == {"decay", "no_decay"}:
        inner = {"0": _adam_state(ocr, groups["decay"] + groups["no_decay"], None),
                 "1": {"inner_state": {}}, "2": {}}
    elif set(groups) == {"all"}:
        inner = {"0": _adam_state(ocr, groups["all"], None), "1": {}}
    else:
        raise KeyError(f"no optax layout for the optimizer groups {sorted(groups)}")
    return {"0": {}, "1": inner} if ocr.clip is not None else inner


def load_optax_state(ocr, tree: dict) -> None:
    """Set the port OCR's optimizer from JAX's optimizer state dict of the
    same OCR (``optax_state``'s inverse): the moments of every parameter,
    torch's per-parameter ``step`` and the optimizer's ``count`` from
    optax's count."""
    opt = ocr.optimizer
    if ocr.clip is not None:
        tree = tree["1"]
    if "inner_states" in tree:
        adams = [s["inner_state"]["0"] for s in tree["inner_states"].values()]
    else:
        adams = [tree["0"]]
    params = dict(ocr.module.named_parameters())
    counts = {int(np.asarray(a["count"])) for a in adams}
    if len(counts) != 1:
        raise ValueError(f"the optimizer's groups hold different counts {sorted(counts)}")
    count = counts.pop()
    found: dict[str, dict] = {}
    for a in adams:
        mu, nu = ocr_from_flax(a["mu"]), ocr_from_flax(a["nu"])
        for name in mu:
            found[name] = {"exp_avg": mu[name], "exp_avg_sq": nu[name]}
    if set(found) != set(params):
        raise KeyError(f"optimizer state for {sorted(set(found) ^ set(params))[:5]} "
                       "does not match the module's parameters")
    opt.adam.state.clear()
    if count:
        for name, p in params.items():
            opt.adam.state[p] = {
                "step": torch.tensor(float(count)),
                **{k: v.to(p.device, p.dtype).clone() for k, v in found[name].items()}}
    opt.count = count


# -- the way back for a whole policy, and its PPO / A2C optimizer state -----------

# (port module path, flax module path) of a policy's tree outside its OCR,
# full matches, the inverse of _MODULES' pooling, acnet and head rules
_POLICY_TO_FLAX = [
    (r"pooling_module\.core\.proj", "pooling_module/CoreTransformer_0/Dense_0"),
    (r"pooling_module\.core\.layers\.(\d+)\.attn\.(query|key|value|out)",
     r"pooling_module/CoreTransformer_0/TorchEncoderLayer_\1/MultiHeadDotProductAttention_0/\2"),
    (r"pooling_module\.core\.layers\.(\d+)\.norm([12])",
     lambda m: f"pooling_module/CoreTransformer_0/TorchEncoderLayer_{m[1]}/"
               f"LayerNorm_{int(m[2]) - 1}"),
    (r"pooling_module\.core\.layers\.(\d+)\.linear([12])",
     lambda m: f"pooling_module/CoreTransformer_0/TorchEncoderLayer_{m[1]}/"
               f"Dense_{int(m[2]) - 1}"),
    (r"pooling_module\.core", "pooling_module/CoreTransformer_0"),
    (r"pooling_module\.dense\.(\d+)", r"pooling_module/Dense_\1"),
    (r"pooling_module\.embed\.(\d+)", r"pooling_module/Embed_\1"),
    (r"pooling_module\.mlp\.(\d+)", r"pooling_module/MLP_0/Dense_\1"),
    (r"pooling_module\.cnn\.convs\.(\d+)", r"pooling_module/PoolNatureCNN_0/Conv_\1"),
    (r"pooling_module\.cnn\.dense", "pooling_module/PoolNatureCNN_0/Dense_0"),
    (r"pooling_module\.(arm_emb|obj_emb)", r"pooling_module/\1"),
    (r"acnet\.(shared|policy|value)\.(\d+)", r"acnet/\1_\2"),
    (r"(action_net|value_net_out)", r"\1"),
    (r"(actor|q1|q2)_(\d+|out)", r"\1_\2"),
    (r"head\.dense\.(\d+)", r"head/Dense_\1"),
]
_OCR = "ocr_module."


def _set(tree: dict, path: str, leaf: str, x: np.ndarray) -> None:
    node = tree
    for part in [p for p in path.split("/") if p]:
        node = node.setdefault(part, {})
    node[leaf] = np.array(x, order="C")


def to_flax(state: dict[str, torch.Tensor], heads: dict[str, int] | None = None) -> dict:
    """The port policy's ``state_dict`` -> JAX's parameter tree of the same
    ``ActorCriticPolicy`` (``algo.params``), the exact inverse of
    ``from_flax``: the OCR's leaves through ``ocr_to_flax``, the pooling's,
    the acnet's and the heads' by the inverse rules. ``heads`` gives the
    heads of each attention (``attention_heads(policy)``)."""
    heads = heads or {}
    ocr = {k[len(_OCR):]: v for k, v in state.items() if k.startswith(_OCR)}
    ocr_heads = {k[len(_OCR):]: v for k, v in heads.items() if k.startswith(_OCR)}
    tree: dict = {"ocr_module": ocr_to_flax(ocr, ocr_heads)} if ocr else {}
    for key, value in state.items():
        if key.startswith(_OCR):
            continue
        module, _, name = key.rpartition(".")
        for pattern, repl in _POLICY_TO_FLAX:
            if re.fullmatch(pattern, module):
                path = re.sub(pattern, repl, module)
                break
        else:
            raise KeyError(f"no flax counterpart for the port parameter '{key}'")
        x = value.detach().cpu().numpy()
        if re.fullmatch(r"pooling_module\.embed\.\d+", module) and name == "weight":
            leaf = "embedding"
        else:
            leaf, x = _flax_leaf(module, name, x, heads.get(module.rsplit(".", 1)[0]), None)
        _set(tree, path, leaf, x)
    return tree


def _stack(trees: list) -> dict:
    """Trees of one layout -> one tree whose leaves are stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _unstack(tree: dict, i: int) -> dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def to_flax_stacked(state: dict[str, torch.Tensor], heads: dict[str, int] | None = None,
                    ) -> dict:
    """``to_flax`` of a state whose every leaf carries a leading seed axis:
    JAX's tree of a multi-seed algorithm (every leaf [S, ...])."""
    S = next(iter(state.values())).shape[0]
    return _stack([to_flax({k: v[i] for k, v in state.items()}, heads) for i in range(S)])


def from_flax_stacked(params: dict) -> dict[str, torch.Tensor]:
    """``from_flax`` of a tree whose every leaf carries a leading seed axis."""
    S = np.asarray(next(v for _, v in _flatten(params))).shape[0]
    per_seed = [from_flax(_unstack(params, i)) for i in range(S)]
    return {k: torch.stack([p[k] for p in per_seed]) for k in per_seed[0]}


def rl_optax_state(kind: str, count, mu: dict, nu: dict, params: dict,
                   frozen_ocr: bool, heads: dict[str, int] | None = None,
                   stacked: bool = False) -> dict:
    """The optimizer state of JAX's PPO / A2C (ocrl_tpu/rl/ppo.py:95-105) as
    flax's state dict: ``chain(clip_by_global_norm`` (an empty state), then
    ``adam`` ({count, mu, nu}, then the learning rate's empty state) or
    ``rmsprop`` ({nu} and two empty states)``)``; with the OCR frozen (and a
    policy that has OCR parameters) inside ``multi_transform({"train": ...,
    "frozen": set_to_zero})``, whose moments hold the frozen leaves as {}
    (optax's MaskedNode). ``mu`` / ``nu``: port name -> array of the
    trainable parameters; ``params``: every parameter of the policy, for the
    masked layout; ``count``: an int, or [S] with ``stacked`` (every leaf
    then carries the seed axis)."""
    flax = to_flax_stacked if stacked else to_flax
    moments = {}
    for key, values in (("mu", mu), ("nu", nu)):
        if values is None:
            continue
        tree = flax(values, heads)
        moments[key] = _mask_like(flax(params, heads), tree) if frozen_ocr else tree
    if kind == "adam":
        inner = adam_optax_state(count, moments["mu"], moments["nu"])
    elif kind == "rmsprop":
        inner = {"0": moments, "1": {}, "2": {}}
    else:
        raise ValueError(f"optimizer must be adam or rmsprop, not '{kind}'")
    chain = {"0": {}, "1": inner}
    if frozen_ocr:
        return {"inner_states": {"frozen": {"inner_state": {}},
                                 "train": {"inner_state": chain}}}
    return chain


def adam_optax_state(count, mu: dict, nu: dict) -> dict:
    """optax.adam's state as flax's state dict: ``(ScaleByAdamState(count,
    mu, nu), EmptyState())``, the moments already flax trees."""
    return {"0": {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}, "1": {}}


def part_to_flax(prefix: str, state: dict[str, torch.Tensor],
                 heads: dict[str, int] | None = None) -> dict:
    """JAX's tree of one part of a model whose flax tree nests it under
    ``prefix`` ("pooling_module" for a pooling, "head" for the probes'
    Dense stacks, whose rules name it so): the part's own ``state_dict`` ->
    its flax params ({} for a part without parameters). ``heads`` as for
    ``to_flax``, relative to the part."""
    tree = to_flax({f"{prefix}.{k}": v for k, v in state.items()},
                   {f"{prefix}.{k}": v for k, v in (heads or {}).items()})
    return tree.get(prefix, {})


def part_from_flax(prefix: str, tree: dict) -> dict[str, torch.Tensor]:
    """``part_to_flax``'s inverse: the part's flax params -> its own
    ``state_dict``."""
    return {k[len(prefix) + 1:]: v for k, v in from_flax({prefix: tree}).items()}


def part_adam_tree(prefix: str, optimizer, names: list[str],
                   heads: dict[str, int] | None = None) -> dict:
    """optax.adam's state of one part (``part_to_flax``'s ``prefix`` and
    ``heads``) from its ``rl.ppo.OptaxChain``, whose moments follow the
    part's parameter ``names``."""
    moments = [part_to_flax(prefix, dict(zip(names, m)), heads)
               for m in (optimizer.mu, optimizer.nu)]
    return adam_optax_state(optimizer.count, *moments)


def load_part_adam(prefix: str, optimizer, names: list[str], tree: dict) -> None:
    """Set one part's ``OptaxChain`` from ``part_adam_tree``'s tree."""
    adam = tree["0"]
    mu, nu = part_from_flax(prefix, adam["mu"]), part_from_flax(prefix, adam["nu"])
    optimizer.load_state_dict({"count": int(np.asarray(adam["count"])),
                               "mu": [mu[n] for n in names], "nu": [nu[n] for n in names]})


def rl_optax_moments(tree: dict, stacked: bool = False) -> tuple:
    """(count or None, mu or None, nu) of ``rl_optax_state``'s tree, the
    moments as port name -> tensor (masked leaves left out)."""
    if "inner_states" in tree:
        tree = tree["inner_states"]["train"]["inner_state"]
    state = tree["1"]["0"]
    convert = from_flax_stacked if stacked else from_flax
    count = np.asarray(state["count"]) if "count" in state else None
    mu = convert(state["mu"]) if "mu" in state else None
    return count, mu, convert(state["nu"])


def sac_optax_state(groups: dict, params: dict, heads: dict[str, int] | None = None) -> dict:
    """The optimizer state of JAX's SAC (ocrl_tpu/rl/sac.py:204-210) as
    flax's state dict: ``multi_transform({"actor": adam, "critic": adam,
    "frozen": set_to_zero})``, each Adam's moments over the whole parameter
    tree with the other groups' leaves as {} (optax's MaskedNode).
    ``groups``: "actor" and "critic" -> (count, mu, nu), the moments as port
    name -> array; ``params``: every parameter of the policy."""
    full = to_flax(params, heads)
    states = {}
    for group in ("actor", "critic"):
        count, mu, nu = groups[group]
        states[group] = {"inner_state": {"0": {
            "count": np.asarray(count, np.int32),
            "mu": _mask_like(full, to_flax(mu, heads)),
            "nu": _mask_like(full, to_flax(nu, heads))}, "1": {}}}
    states["frozen"] = {"inner_state": {}}
    return {"inner_states": states}


def sac_optax_moments(tree: dict) -> dict:
    """``sac_optax_state``'s inverse: "actor" and "critic" -> (count, mu,
    nu), the moments as port name -> tensor (masked leaves left out)."""
    out = {}
    for group in ("actor", "critic"):
        state = tree["inner_states"][group]["inner_state"]["0"]
        out[group] = (int(np.asarray(state["count"])), from_flax(state["mu"]),
                      from_flax(state["nu"]))
    return out
