"""Checkpoint files of the JAX package, read and written without flax or
msgpack (counterpart of ocrl_tpu/utils/checkpoint.py).

A file is ``OCRLTPU1``, the length of a JSON metadata block as a little-
endian u64, the JSON, then the tree as flax's msgpack payload
(ocrl_tpu/utils/checkpoint.py:23-37). ``load_checkpoint`` decodes the subset
of msgpack that flax writes for a model's tree: maps, arrays, str, bin,
ints, floats, nil and bool, and flax's extension types 1 (an ndarray, whose
payload is itself msgpack ``[shape, dtype name, buffer]``) and 3 (a numpy
scalar, the same payload). It returns what
``flax.serialization.msgpack_restore`` returns: nested dicts (flax keeps
tuples and lists as maps keyed "0", "1", ...) of numpy arrays and Python
scalars. (flax cuts an array above 2^30 bytes into chunks; no model of the
repo holds one, and such a leaf comes back as flax's chunk map.) ``packb``
encodes such a tree the way flax does, every ndarray (0-d ones too) as
extension type 1, and ``save_checkpoint`` writes the file through a
temporary name and an atomic rename.

``save`` / ``load`` are the training loop's checkpoints
(ocrl_tpu/utils/checkpoint.py:103-148): ``checkpoints/model_{step}.ckpt``,
``model_latest.ckpt`` and, on a new best, ``model_best.ckpt``, holding JAX's
tree of the OCR (``convert.ocr_to_flax``) and of its optimizer state
(``convert.optax_state``), so that JAX's ``ocrl_tpu.utils.load`` resumes
from a file the port wrote and the port from a file JAX wrote.

``save_algo`` / ``load_algo`` are the RL agent files (train_sb3's
``models/best_model.ckpt`` and ``latest_model.ckpt``): JAX's ``algo.save()``
tree ``{"policy_params", "opt_state", "num_timesteps"[, "seeds"]}`` of a
PPO, an A2C or a multi-seed PPO (``agent_tree``; ``convert.to_flax`` and
``convert.rl_optax_state``), or SAC's ``{"policy_params", "target_params",
"opt_state", "log_alpha", "num_timesteps"}`` (``convert.sac_optax_state``),
so that JAX's ``test_sb3`` and ``+resume=``
read a file the port wrote and the port resumes from a file JAX wrote. With
``allow_partial`` a file that lacks whole parts (the committed params-only
agents have no ``opt_state``) keeps the algorithm's own values for them
(ocrl_tpu/utils/checkpoint.py:78-101): a fresh optimizer.

``get_ocr`` builds the port's OCR from its configs and, when a checkpoint is
configured, loads the JAX OCR's parameters from it
(ocrl_tpu/poolings/wrapper.py:49-63): ``ocr_module_state_dict`` through
``convert.ocr_from_flax``, keeping the fresh module's values for parameters
the payload lacks, and the optimizer state where the file holds one and the
OCR has an optimizer, as JAX's partial load of ``OCR.save()`` does.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ..models import create_ocr
import torch

from .convert import (attention_heads, from_flax, from_flax_stacked, load_optax_state,
                      ocr_from_flax, ocr_to_flax, optax_state, rl_optax_moments,
                      rl_optax_state, sac_optax_moments, sac_optax_state, to_flax,
                      to_flax_stacked)
from .torch_convert import load_reference_checkpoint

_MAGIC = b"OCRLTPU1"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# (format byte, struct code of the big-endian length or value)
_SIZED = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",                 # bin
          0xd9: ">B", 0xda: ">H", 0xdb: ">I",                 # str
          0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",     # array, map
          0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}                 # ext
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack payload ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, code: str):
        return struct.unpack(code, self.take(struct.calcsize(code)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            kind = self.unpack(">b")
            return _extension(kind, bytes(self.take(_FIXEXT[b])))
        if b in _SIZED:
            n = self.unpack(_SIZED[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b <= 0xc9:
                kind = self.unpack(">b")
                return _extension(kind, bytes(self.take(n)))
            if b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b <= 0xdd:
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack format byte 0x{b:02x} is not one flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _extension(kind: int, payload: bytes):
    if kind in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype, buffer = unpackb(payload)
        array = np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)
        return array if kind == _EXT_NDARRAY else array[()]
    raise ValueError(f"msgpack extension type {kind} is not one flax writes")


def unpackb(data: bytes):
    """Decode one msgpack value that fills ``data``."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return value


def _pack_length(out: bytearray, n: int, small: int | None, codes: tuple) -> None:
    """The header of a sized msgpack value: ``small | n`` when it fits,
    else the first of the 8/16/32-bit length codes that holds n."""
    if small is not None and n < (16 if small in (0x80, 0x90) else 32):
        out.append(small | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"a msgpack value of {n} entries or bytes is too long")


def _pack_ext(out: bytearray, kind: int, payload) -> None:
    """An extension value whose payload is ``payload``'s pieces, in order."""
    size = sum(len(p) for p in payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if size in fixed:
        out.append(fixed[size])
    else:
        _pack_length(out, size, None, (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", kind)
    for piece in payload:
        out += piece


def _pack(value, out: bytearray) -> None:
    if value is None:
        out.append(0xc0)
    elif value is True or value is False:
        out.append(0xc3 if value else 0xc2)
    elif isinstance(value, (np.ndarray, np.generic)):
        # the payload is msgpack [shape, dtype name, bin of the C-order
        # bytes]; the array's buffer is copied once, into ``out``
        array = np.asarray(value)
        if not array.flags.c_contiguous:
            array = array.copy(order="C")
        data = memoryview(array.reshape(-1)).cast("B")
        head = bytearray([0x93])
        _pack(list(array.shape), head)
        _pack(array.dtype.name, head)
        _pack_length(head, len(data), None, (0xc4, 0xc5, 0xc6))
        _pack_ext(out, _EXT_NDARRAY if isinstance(value, np.ndarray) else _EXT_NPSCALAR,
                  (head, data))
    elif isinstance(value, int):
        if 0 <= value < 0x80:
            out.append(value)
        elif -32 <= value < 0:
            out.append(value & 0xff)
        elif value >= 0:
            for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")):
                if value < 1 << (8 * struct.calcsize(fmt)):
                    out += bytes([code]) + struct.pack(fmt, value)
                    return
            raise ValueError(f"{value} is too large for msgpack")
        else:
            for code, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")):
                if value >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out += bytes([code]) + struct.pack(fmt, value)
                    return
            raise ValueError(f"{value} is too small for msgpack")
    elif isinstance(value, float):
        out += b"\xcb" + struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode()
        _pack_length(out, len(raw), 0xa0, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        _pack_length(out, len(raw), None, (0xc4, 0xc5, 0xc6))
        out += raw
    elif isinstance(value, dict):
        _pack_length(out, len(value), 0x80, (None, 0xde, 0xdf))
        for key, item in value.items():
            _pack(key, out)
            _pack(item, out)
    elif isinstance(value, (list, tuple)):
        _pack_length(out, len(value), 0x90, (None, 0xdc, 0xdd))
        for item in value:
            _pack(item, out)
    else:
        raise TypeError(f"msgpack cannot encode {type(value).__name__}")


def packb(value) -> bytes:
    """``value`` as msgpack, as flax's ``msgpack_serialize`` encodes a state
    dict: maps, lists, str, bytes (bin), ints, floats (64-bit), bool, nil,
    ndarrays as extension type 1 and numpy scalars as type 3."""
    out = bytearray()
    _pack(value, out)
    return bytes(out)


def _write(path: Path, payload: bytes, metadata: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = json.dumps(metadata).encode()
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(meta)))
        f.write(meta)
        f.write(payload)
    tmp.replace(path)


def save_checkpoint(path: str | Path, tree: dict, metadata: dict) -> None:
    """Write an ``OCRLTPU1`` file of ``tree`` (a state dict of numpy arrays)
    and ``metadata`` through a temporary file and an atomic rename, so a
    crash mid-write never leaves a truncated checkpoint."""
    _write(Path(path), packb(tree), metadata)


def load_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """(tree, metadata) of an ``OCRLTPU1`` file."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"not an ocrl_tpu checkpoint: {path}")
        (meta_len,) = struct.unpack("<Q", f.read(8))
        metadata = json.loads(f.read(meta_len).decode())
        payload = f.read()
    return unpackb(payload), metadata


def migrate_bcdec_tree(d):
    """Rename broadcast-decoder state saved under the older
    ``blocks/layers_{0..3}`` layout to the ``conv1`` / ``rest`` layout
    (ocrl_tpu/utils/checkpoint.py:40-63), recursively, so that optimizer
    mirrors of the tree move too."""
    if not isinstance(d, dict):
        return d
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k == "bcdec" and "blocks" in v \
                and "layers_0" in v["blocks"]:
            b = v["blocks"]
            nv = {kk: migrate_bcdec_tree(vv) for kk, vv in v.items() if kk != "blocks"}
            nv["conv1"] = b["layers_0"]["Conv_0"]
            nv["rest"] = {"layers_0": b["layers_1"], "layers_1": b["layers_2"],
                          "layers_2": b["layers_3"]}
            out[k] = nv
        else:
            out[k] = migrate_bcdec_tree(v)
    return out


def resolve_ocr_checkpoint_path(cpt_config) -> Path | None:
    """``local_file``, else the best or latest checkpoint of the local run
    directory ``run_id``, else None (ocrl_tpu/poolings/wrapper.py:26-46)."""
    if cpt_config.local_file:
        path = Path(cpt_config.local_file)
        if not path.exists():
            raise FileNotFoundError(f"OCR checkpoint not found: {path}")
        return path
    if cpt_config.run_id:
        for name in ("model_best.ckpt", "model_latest.ckpt"):
            path = Path(cpt_config.run_id) / "checkpoints" / name
            if path.exists():
                return path
        raise FileNotFoundError(f"no checkpoint under the run directory "
                                f"'{cpt_config.run_id}'")
    return None


def load_ocr_file(ocr, path: str | Path) -> None:
    """Set ``ocr`` from the OCR of a checkpoint file: every parameter the
    file holds (the others keep their values) and the optimizer state
    where the file holds one, as JAX's partial load of
    ``OCR.save()`` does (ocrl_tpu/poolings/wrapper.py:49-63)."""
    tree = migrate_bcdec_tree(load_checkpoint(path)[0])
    state = ocr.module.state_dict()     # what the payload lacks keeps its value
    state.update(ocr_from_flax(tree["ocr_module_state_dict"]))
    ocr.module.load_state_dict(state)
    if ocr.optimizer is not None and "ocr_opt_state_dict" in tree:
        load_optax_state(ocr, tree["ocr_opt_state_dict"])


def get_ocr(ocr_config, env_config, cpt_config, seed: int = 0, device=None):
    """(OCR, pretrained): the OCR of the configs, with the weights of the
    configured checkpoint when there is one: a reference-format ``.pth``
    file through ``torch_convert.load_reference_checkpoint``, any other
    through ``load_ocr_file`` (ocrl_tpu/poolings/wrapper.py:49-63)."""
    ocr = create_ocr(ocr_config, env_config, seed, device)
    path = resolve_ocr_checkpoint_path(cpt_config)
    if path is None:
        return ocr, False
    if path.suffix == ".pth":
        load_reference_checkpoint(path, ocr)
        return ocr, True
    load_ocr_file(ocr, path)
    return ocr, True


def checkpoint_tree(ocr) -> dict:
    """JAX's ``OCR.save()`` state dict of the port's OCR: the module's tree
    and, with an optimizer, its optax state."""
    tree = {"ocr_module_state_dict": ocr_to_flax(ocr.module.state_dict(),
                                                 attention_heads(ocr.module))}
    if ocr.optimizer is not None:
        tree["ocr_opt_state_dict"] = optax_state(ocr)
    return tree


def load_tree(ocr, tree: dict) -> None:
    """Set the port's OCR from JAX's ``OCR.save()`` state dict: every
    parameter, and the optimizer state where the tree holds one."""
    tree = migrate_bcdec_tree(tree)
    ocr.module.load_state_dict(ocr_from_flax(tree["ocr_module_state_dict"]))
    if ocr.optimizer is not None and "ocr_opt_state_dict" in tree:
        load_optax_state(ocr, tree["ocr_opt_state_dict"])


def save(ocr, run_dir: str | Path, step: int = 0, epoch: int = 0,
         best_val_loss: float = 1e5, best: bool = False) -> None:
    """``<run_dir>/checkpoints/model_{step}.ckpt`` and ``model_latest.ckpt``,
    and ``model_best.ckpt`` when ``best``, with the metadata step, epoch
    and best_val_loss (ocrl_tpu/utils/checkpoint.py:103-117). A sharded OCR
    (``parallel.shard_ocr``) holds the same state on every rank: rank 0
    writes, and every rank returns once the files are there."""
    if ocr.shard is None or ocr.shard[0] == 0:
        ckpt_dir = Path(run_dir) / "checkpoints"
        metadata = {"step": step, "epoch": epoch, "best_val_loss": float(best_val_loss)}
        payload = packb(checkpoint_tree(ocr))          # encoded once for every file
        for name in [f"model_{step}.ckpt", "model_latest.ckpt"] + (
                ["model_best.ckpt"] if best else []):
            _write(ckpt_dir / name, payload, metadata)
    if ocr.shard is not None:
        torch.distributed.barrier(group=ocr.group)


def load(ocr, run_dir: str | Path | None = None, resume_checkpoint: str | None = None,
         resume_run_path: str | None = None) -> tuple[int, int, float]:
    """Resume ``ocr`` from a checkpoint file, JAX's or the port's, in JAX's
    order (ocrl_tpu/utils/checkpoint.py:120-148): ``resume_checkpoint``,
    else the latest of the run ``resume_run_path``, else this run's latest.
    Returns (step, epoch, best_val_loss), or (0, 0, 1e10) with no file."""
    path = None
    if resume_checkpoint is not None:
        path = Path(resume_checkpoint)
    elif resume_run_path is not None:
        path = Path(resume_run_path) / "checkpoints" / "model_latest.ckpt"
    elif run_dir is not None:
        candidate = Path(run_dir) / "checkpoints" / "model_latest.ckpt"
        if candidate.exists():
            path = candidate
    if path is None or not path.exists():
        return 0, 0, 1e10
    tree, metadata = load_checkpoint(path)
    load_tree(ocr, tree)
    return metadata["step"], metadata.get("epoch", 0), metadata.get("best_val_loss", 1e10)


# -- RL agent files --------------------------------------------------------------


def _agent_params(algo) -> tuple[dict, bool]:
    """(every policy parameter, name -> tensor, whether stacked over seeds)."""
    if hasattr(algo, "seeds"):
        return algo.params, True
    return {n: p.detach() for n, p in algo.policy.named_parameters()}, False


def _frozen_ocr(algo, params: dict) -> bool:
    return bool(getattr(algo.policy, "freeze_ocr", False)) and \
        any(n.startswith("ocr_module.") for n in params)


def _sac_tree(algo) -> dict:
    """JAX's SAC ``save()`` tree (ocrl_tpu/rl/sac.py:388-393): both
    networks, the two Adams' state, ``log_alpha`` and ``num_timesteps``
    (the entropy coefficient's own Adam state is not saved, in JAX
    either)."""
    params, _ = _agent_params(algo)
    heads = attention_heads(algo.policy)
    groups = {}
    for group, opt in algo.optimizers.items():
        names = algo.param_names[group]
        groups[group] = (opt.count, dict(zip(names, opt.mu)), dict(zip(names, opt.nu)))
    target = {n: p.detach() for n, p in algo.target.named_parameters()}
    return {"policy_params": to_flax(params, heads), "target_params": to_flax(target, heads),
            "opt_state": sac_optax_state(groups, params, heads),
            "log_alpha": algo.log_alpha.detach().cpu().numpy(),
            "num_timesteps": int(algo.num_timesteps)}


def _load_sac_tree(algo, tree: dict, allow_partial: bool) -> None:
    wanted = ["policy_params", "target_params", "opt_state", "log_alpha", "num_timesteps"]
    missing = [k for k in wanted if k not in tree]
    if missing and not allow_partial:
        raise ValueError(f"the agent file lacks {missing} (allow_partial keeps the "
                         "algorithm's own)")
    with torch.no_grad():
        for key, module in (("policy_params", algo.policy), ("target_params", algo.target)):
            if key not in tree:
                continue
            own = dict(module.named_parameters())
            loaded = from_flax(tree[key])
            if set(loaded) != set(own):
                raise KeyError(f"the file's {key} differ in "
                               f"{sorted(set(loaded) ^ set(own))[:5]}")
            for name, value in loaded.items():
                own[name].copy_(value)
        if "opt_state" in tree:
            for group, (count, mu, nu) in sac_optax_moments(tree["opt_state"]).items():
                names = algo.param_names[group]
                if set(mu) != set(names):
                    raise KeyError(f"the file's {group} optimizer holds other parameters: "
                                   f"{sorted(set(mu) ^ set(names))[:5]}")
                algo.optimizers[group].load_state_dict(
                    {"count": count, "mu": [mu[n] for n in names], "nu": [nu[n] for n in names]})
        if "log_alpha" in tree:
            algo.log_alpha.copy_(torch.from_numpy(np.array(tree["log_alpha"], np.float32)))
    if "num_timesteps" in tree:
        algo.num_timesteps = int(tree["num_timesteps"])


def agent_tree(algo) -> dict:
    """JAX's ``algo.save()`` state dict of the port's PPO, A2C,
    MultiSeedPPO or SAC: the policy's tree, the optimizer's, ``num_timesteps``
    and, for several seeds, ``seeds`` (every other leaf then [S, ...]); for
    SAC also the target's tree and ``log_alpha``."""
    if hasattr(algo, "target"):
        return _sac_tree(algo)
    params, stacked = _agent_params(algo)
    heads = attention_heads(algo.policy)
    opt = algo.optimizer
    names = algo.param_names
    mu = dict(zip(names, opt.mu)) if opt.kind == "adam" else None
    count = opt.count.cpu().numpy() if stacked else opt.count
    tree = {"policy_params": (to_flax_stacked if stacked else to_flax)(params, heads),
            "opt_state": rl_optax_state(opt.kind, count, mu, dict(zip(names, opt.nu)),
                                        params, _frozen_ocr(algo, params), heads, stacked),
            "num_timesteps": int(algo.num_timesteps)}
    if stacked:
        tree["seeds"] = {str(i): int(s) for i, s in enumerate(algo.seeds)}
    return tree


def load_agent_tree(algo, tree: dict, allow_partial: bool = False) -> None:
    """Set the port's algorithm from JAX's ``algo.save()`` state dict
    (``agent_tree``'s inverse). A stacked tree's ``seeds`` must be the
    algorithm's, as JAX's ``MultiSeedPPO.load`` demands; a part the tree
    lacks raises unless ``allow_partial``, which keeps the algorithm's own."""
    if hasattr(algo, "target"):
        _load_sac_tree(algo, tree, allow_partial)
        return
    params, stacked = _agent_params(algo)
    wanted = ["policy_params", "opt_state", "num_timesteps"] + (["seeds"] if stacked else [])
    missing = [k for k in wanted if k not in tree]
    if missing and not allow_partial:
        raise ValueError(f"the agent file lacks {missing} (allow_partial keeps the "
                         "algorithm's own)")
    if stacked and "seeds" in tree:
        saved = [int(tree["seeds"][k]) for k in sorted(tree["seeds"], key=int)]
        if saved != algo.seeds:
            raise ValueError(
                f"checkpoint was trained with seeds={saved} but this run has "
                f"seeds={algo.seeds}: per-seed params would be misattributed")
    if "policy_params" in tree:
        loaded = (from_flax_stacked if stacked else from_flax)(tree["policy_params"])
        if set(loaded) != set(params):
            raise KeyError(f"the file's policy differs in {sorted(set(loaded) ^ set(params))[:5]}")
        with torch.no_grad():
            for name, value in loaded.items():
                params[name].copy_(value)
    if "opt_state" in tree:
        count, mu, nu = rl_optax_moments(tree["opt_state"], stacked)
        opt = algo.optimizer
        state = {"count": opt.count if count is None else
                 (torch.from_numpy(np.array(count)) if stacked else int(count)),
                 "mu": [mu[n] for n in algo.param_names] if mu is not None else [],
                 "nu": [nu[n] for n in algo.param_names]}
        opt.load_state_dict(state)
    if "num_timesteps" in tree:
        algo.num_timesteps = int(tree["num_timesteps"])


def save_algo(path: str | Path, algo, metadata: dict) -> None:
    """An ``OCRLTPU1`` agent file of ``algo`` (``agent_tree``)."""
    save_checkpoint(path, agent_tree(algo), metadata)


def load_algo(path: str | Path, algo, allow_partial: bool = False) -> dict:
    """Set ``algo`` from an agent file, JAX's or the port's; its metadata."""
    tree, metadata = load_checkpoint(path)
    load_agent_tree(algo, tree, allow_partial)
    return metadata
