"""The port's reader of the JAX package's checkpoint files
(ocrl_tpu_torch/utils/checkpoint.py), which needs neither flax nor msgpack,
against flax itself: every committed ``.ckpt`` decodes to what
``flax.serialization.msgpack_restore`` gives, to the byte; so does a payload
holding every msgpack form that flax writes; an older broadcast-decoder
layout migrates as the JAX package migrates it; and a JAX OCR's checkpoint
loads into the port's OCR with its weights exactly. (The port evaluating
such a loaded OCR equal to the JAX OCR is test_torch_eval.py's
test_evaluate_matches_the_jax_loop.)"""

import json
import struct
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

import jax
from flax import serialization

from ocrl_tpu.config import compose
from ocrl_tpu.models import create_ocr as jcreate_ocr
from ocrl_tpu.utils import checkpoint as jckpt

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.utils import checkpoint as tckpt
from ocrl_tpu_torch.utils.convert import ocr_from_flax

from test_torch_eval import SMALL, port_eval_config

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "artifacts").rglob("*.ckpt"))


def assert_same_tree(got, want, path="tree"):
    """Same keys in the same order, same types; arrays of the same dtype,
    shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            assert_same_tree(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want or (got != got and want != want), (path, got, want)


def flat(tree, prefix=""):
    """A nested dict's leaves by path, in sorted order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree):
        out.update(flat(tree[key], f"{prefix}/{key}"))
    return out


def envelope(path):
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[8:16])
    return json.loads(raw[16:16 + n]), raw[16 + n:]


def test_every_committed_checkpoint_is_found():
    assert len(COMMITTED) == 8, COMMITTED


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_checkpoints_decode_as_flax_does(name):
    path = ROOT / name
    metadata, payload = envelope(path)
    tree, got_metadata = tckpt.load_checkpoint(path)
    assert got_metadata == metadata
    assert_same_tree(tree, serialization.msgpack_restore(payload))
    if name.startswith("artifacts/rl/"):      # stacked over three seeds
        assert list(tree["seeds"]) == ["0", "1", "2"]
        kernel = tree["policy_params"]["action_net"]["kernel"]
        assert kernel.shape[0] == 3 and kernel.dtype == np.float32


def test_every_msgpack_form_flax_writes():
    """fixint, int8-64, uint8-64, float32 and float64, nil, bools, str and
    bin of each length class, fixarray and array16, fixmap and map16, and
    flax's extensions 1 and 3 (ndarrays of several dtypes, numpy scalars,
    a payload of 16 bytes packed as fixext 16)."""
    tree = {
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63,
             128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1])},
        "floats": {"a": 1.5, "b": -0.0, "c": float("inf"), "d": float("nan")},
        "nil": None, "yes": True, "no": False,
        "strs": {"fix": "x" * 31, "s8": "y" * 32, "s16": "z" * 300, "s32": "w" * 70000,
                 "utf8": "grüße"},
        "bins": {"b8": b"\x00" * 3, "b16": b"\x01" * 300, "b32": b"\x02" * 70000},
        "lists": {"fix": [1, [2, 3]], "a16": list(range(20))},
        "big_map": {f"k{i}": i for i in range(20)},
        "arrays": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "i64": np.array([-1, 2 ** 40], np.int64),
                   "u8": np.arange(5, dtype=np.uint8), "b": np.array([True, False]),
                   "f16": np.ones((2, 2), np.float16), "c64": np.array([1 + 2j], np.complex64),
                   "empty": np.zeros((0, 4), np.float32)},
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7)},
    }
    payload = serialization.msgpack_serialize(tree)
    assert b"\xd8\x03" in payload                  # fixext 16 of type 3: the float32 scalar
    want = serialization.msgpack_restore(payload)
    assert_same_tree(tckpt.unpackb(payload), want)
    singles = msgpack.packb({"f": 1.5, "g": [0.25, -3.0]}, use_single_float=True)
    assert singles[3] == 0xca                     # packed as float32
    assert_same_tree(tckpt.unpackb(singles), msgpack.unpackb(singles))
    with pytest.raises(ValueError, match="after the msgpack value"):
        tckpt.unpackb(payload + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        tckpt.unpackb(payload[:-1])


def test_not_a_checkpoint(tmp_path):
    path = tmp_path / "x.ckpt"
    path.write_bytes(b"NOTMAGIC" + bytes(8))
    with pytest.raises(ValueError, match="not an ocrl_tpu checkpoint"):
        tckpt.load_checkpoint(path)


def _jax_ocr(ocr):
    cfg = compose("train_sb3", [f"ocr={ocr}", "env=target-N4C4S3S1", "pooling=transformer",
                                "sb3=ppo", "sb3_acnet=mlp"] + [f"{k}={v}" for k, v in SMALL])
    return jcreate_ocr(cfg.ocr, cfg.env, seed=4)


def _old_bcdec_layout(params):
    """A Slot-Attention tree in the layout before the first conv was split
    out of its block (tests/test_slate.py:207-242)."""
    sd = serialization.to_state_dict(params)
    old = dict(sd)
    bc = sd["bcdec"]
    old["bcdec"] = {"pos_emb": bc["pos_emb"], "blocks": {
        "layers_0": {"Conv_0": bc["conv1"]}, "layers_1": bc["rest"]["layers_0"],
        "layers_2": bc["rest"]["layers_1"], "layers_3": bc["rest"]["layers_2"]}}
    return old


def test_old_bcdec_layout_migrates_as_jax_does(tmp_path):
    """migrate_bcdec_tree renames as the JAX package's does, in the params
    and in an optimizer mirror; a checkpoint in the old layout loads into
    the port's Slot-Attention OCR with every weight in place."""
    jocr = _jax_ocr("slotattention")
    params = jax.tree.map(np.asarray, jocr.params)
    old = _old_bcdec_layout(params)
    tree = {"params": old, "opt": {"mu": old}}
    want = jckpt.migrate_bcdec_tree(tree)
    assert_same_tree(tckpt.migrate_bcdec_tree(tree), want)

    path = tmp_path / "old.ckpt"
    jckpt.save_checkpoint(path, {"ocr_module_state_dict": old}, {"step": 3})
    port = port_eval_config(True, **{"ocr_checkpoint.local_file": str(path)})
    ocr, pretrained = tckpt.get_ocr(port.ocr, port.env, port.ocr_checkpoint, device="cpu")
    assert pretrained
    want_state = ocr_from_flax(params)
    got_state = ocr.module.state_dict()
    assert set(want_state) == set(got_state)
    for key, value in want_state.items():
        assert torch.equal(got_state[key], value), key


def test_jax_ocr_checkpoint_loads_into_the_port(tmp_path):
    """A SLATE run directory saved by ocrl_tpu.utils.checkpoint.save (params
    and optimizer state) loads through get_ocr(run_id=...) with every
    weight and the optimizer state exactly, as JAX's get_ocr loads both
    (ocrl_tpu/poolings/wrapper.py:49-63). A payload that lacks a subtree (a
    params-only export without ``out``) keeps the fresh module's values
    there, as allow_partial does."""
    jocr = _jax_ocr("slate")
    jocr.update(np.zeros((2, 16, 16, 3), np.uint8), None, 0)   # weights off their init
    params = jax.tree.map(np.asarray, jocr.params)
    jckpt.save(jocr, tmp_path / "run", step=1)
    port = port_eval_config(**{"ocr_checkpoint.run_id": str(tmp_path / "run")})
    assert tckpt.resolve_ocr_checkpoint_path(port.ocr_checkpoint).name == "model_latest.ckpt"
    ocr, pretrained = tckpt.get_ocr(port.ocr, port.env, port.ocr_checkpoint, device="cpu")
    assert pretrained and ocr.optimizer.count == 1 and ocr._last_step == 0
    want_opt = jax.tree.map(np.asarray, serialization.to_state_dict(jocr.opt_state))
    got_opt = tckpt.checkpoint_tree(ocr)["ocr_opt_state_dict"]
    assert_same_tree(flat(got_opt), flat(want_opt))
    want = ocr_from_flax(params)
    got = ocr.module.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key

    partial = {k: v for k, v in params.items() if k != "out"}
    jckpt.save_checkpoint(tmp_path / "partial.ckpt", {"ocr_module_state_dict": partial}, {})
    fresh, _ = tckpt.get_ocr(port.ocr, port.env, tcfg.OCRCheckpointConfig(), seed=9,
                             device="cpu")
    loaded, _ = tckpt.get_ocr(port.ocr, port.env, tcfg.OCRCheckpointConfig(
        local_file=str(tmp_path / "partial.ckpt")), seed=9, device="cpu")
    assert torch.equal(loaded.module.out.weight, fresh.module.out.weight)
    assert torch.equal(loaded.module.dictionary.weight, want["dictionary.weight"])


def test_checkpoint_paths(tmp_path):
    cfg = tcfg.OCRCheckpointConfig
    assert tckpt.resolve_ocr_checkpoint_path(cfg()) is None
    with pytest.raises(FileNotFoundError, match="not found"):
        tckpt.resolve_ocr_checkpoint_path(cfg(local_file=str(tmp_path / "missing.ckpt")))
    with pytest.raises(FileNotFoundError, match="run directory"):
        tckpt.resolve_ocr_checkpoint_path(cfg(run_id=str(tmp_path)))
    (tmp_path / "checkpoints").mkdir()
    for name in ("model_latest.ckpt", "model_best.ckpt"):
        (tmp_path / "checkpoints" / name).write_bytes(b"")
    assert tckpt.resolve_ocr_checkpoint_path(cfg(run_id=str(tmp_path))).name == \
        "model_best.ckpt"
    # a truncated torch zip file: named .ckpt it is not an ocrl_tpu file; named
    # .pth it goes to the reference-format loader, whose torch.load refuses it
    # as JAX's does (tests/test_torch_reference_checkpoint.py loads real ones)
    for name in ("ref.ckpt", "ref.pth"):
        (tmp_path / name).write_bytes(b"PK\x03\x04" + bytes(12))
    port = port_eval_config()
    with pytest.raises(ValueError, match="not an ocrl_tpu checkpoint"):
        tckpt.get_ocr(port.ocr, port.env, cfg(local_file=str(tmp_path / "ref.ckpt")),
                      device="cpu")
    with pytest.raises(RuntimeError, match="zip archive"):
        tckpt.get_ocr(port.ocr, port.env, cfg(local_file=str(tmp_path / "ref.pth")),
                      device="cpu")
