"""Reference-format ``.pth`` OCR checkpoints: the port's
``utils.torch_convert`` and ``get_ocr``'s ``.pth`` branch against JAX's
``load_reference_checkpoint`` (ocrl_tpu/utils/torch_convert.py).

The original PyTorch OCRL is not here, so the test writes its file: the
parameters of a small JAX SLATE under the reference's names, through the
inverse of each of JAX's ``_slate_key`` transforms (a Linear kernel
transposed back, a conv kernel ``transpose(3, 2, 0, 1)``), beside ``step``,
``epoch``, ``best_val_loss`` and an ``ocr_opt_state_dict`` of tensors.
Both sides load it: the port's parameters are bitwise JAX's (through
``ocr_from_flax``), and one forward agrees to 1e-5 of its largest value.
The errors are JAX's, message for message, the broadcast decoder's
``KeyError`` among them (JAX's map names the decoder's older layout).
"""

import argparse
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.config import compose
from ocrl_tpu.models import create_ocr as jcreate_ocr
from ocrl_tpu.utils import torch_convert as jtc

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.utils import torch_convert
from ocrl_tpu_torch.utils.checkpoint import get_ocr
from ocrl_tpu_torch.utils.convert import attention_heads, ocr_from_flax, ocr_to_flax

SMALL = [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
         ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
         ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
         ("ocr.dvae.d_model", 32), ("ocr.tfdec.num_dec_blocks", 2),
         ("ocr.tfdec.num_dec_heads", 2)]
BOOKKEEPING = {"step": 1234, "epoch": 5, "best_val_loss": 0.25}
_INVERSE = {jtc._linear: lambda x: x.T, jtc._conv: lambda x: x.transpose(3, 2, 0, 1),
            jtc._ident: lambda x: x}


def port_configs(over=()):
    cfg = tcfg.PolicyConfig()
    for path, value in list(SMALL) + list(over):
        cfg = tcfg.replace(cfg, path, value)
    return cfg.ocr, cfg.env


def reference_state_dict(params) -> dict:
    """JAX's tree under the reference's names and layouts (torch tensors)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        segs = [str(getattr(s, "key", s)) for s in path]
        tkey, tf = jtc._slate_key(segs)
        out[tkey] = torch.from_numpy(np.ascontiguousarray(_INVERSE[tf](np.asarray(leaf))))
    return out


def write_pth(path, state_dict: dict, **extra) -> None:
    torch.save({**BOOKKEEPING, "ocr_module_state_dict": state_dict,
                "ocr_opt_state_dict": {"state": {0: {"exp_avg": torch.ones(3)}},
                                       "param_groups": [{"lr": 1e-4, "params": [0]}]},
                **extra}, path)


@pytest.fixture(scope="module")
def jax_slate():
    cfg = compose("train_sb3", ["ocr=slate", "env=target-N4C4S3S1", "pooling=transformer",
                                "sb3=ppo", "sb3_acnet=mlp"] + [f"{k}={v}" for k, v in SMALL])
    return jcreate_ocr(cfg.ocr, cfg.env, seed=0)


@pytest.fixture(scope="module")
def pth(jax_slate, tmp_path_factory):
    """A reference file of JAX's parameters shifted off their init, so a
    load that kept any initial value would show."""
    params = jax.tree.map(lambda x: np.asarray(x) + 0.01, jax_slate.params)
    path = tmp_path_factory.mktemp("pth") / "slate.pth"
    write_pth(path, reference_state_dict(params))
    return path


def test_get_ocr_loads_a_pth_as_jax_does(jax_slate, pth):
    """get_ocr's .pth branch: every parameter bitwise JAX's after JAX's
    load_reference_checkpoint, the bookkeeping dicts equal, and the
    optimizer state left as create_ocr made it, on both sides."""
    opt_before = jax.tree.map(np.asarray, jax_slate.opt_state)
    want_info = jtc.load_reference_checkpoint(pth, jax_slate)
    want = ocr_from_flax(jax.tree.map(np.asarray, jax_slate.params))
    ocr, pretrained = get_ocr(*port_configs(), tcfg.OCRCheckpointConfig(local_file=str(pth)),
                              seed=3, device="cpu")
    assert pretrained
    state = ocr.module.state_dict()
    assert set(want) <= set(state)
    for key, w in want.items():
        assert torch.equal(state[key], w), key
    fresh = create_ocr(*port_configs(), seed=3, device="cpu")
    assert ocr.optimizer.count == 0 and not ocr.optimizer.adam.state
    assert ocr.optimizer.state_dict()["adam"]["param_groups"] == \
        fresh.optimizer.state_dict()["adam"]["param_groups"]
    jax.tree.map(np.testing.assert_array_equal, opt_before,
                 jax.tree.map(np.asarray, jax_slate.opt_state))
    got_info = torch_convert.load_reference_checkpoint(pth, fresh)
    assert got_info == want_info == BOOKKEEPING


def test_forward_after_the_load_matches_jax(jax_slate, pth):
    """One forward (the slots, given the initial slots' noise) of the loaded
    OCR on both sides, to 1e-5 of the slots' largest value."""
    jtc.load_reference_checkpoint(pth, jax_slate)
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    noise = rng.standard_normal((2, 3, 32)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
        want = np.asarray(jax_slate(obs))
    ocr, _ = get_ocr(*port_configs(), tcfg.OCRCheckpointConfig(local_file=str(pth)),
                     device="cpu")
    got = ocr.rep(obs, noise={"rep": torch.from_numpy(noise)}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _both_raise(tmp_path, ocr, state_dict: dict, error):
    """JAX's loader and the port's on one file, each on the same OCR's tree:
    the same error type and message."""
    path = tmp_path / "bad.pth"
    write_pth(path, state_dict)
    template = ocr_to_flax(ocr.module.state_dict(), attention_heads(ocr.module))
    with pytest.raises(error) as want:
        jtc.load_reference_checkpoint(path, SimpleNamespace(name=ocr.name, params=template))
    with pytest.raises(error) as got:
        get_ocr(*port_configs(), tcfg.OCRCheckpointConfig(local_file=str(path)), device="cpu") \
            if ocr.name == "SLATE" and not ocr.module.use_bcdec else \
            torch_convert.load_reference_checkpoint(path, ocr)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_bcdec_raises_jax_s_key_error(tmp_path, jax_slate):
    """JAX's map still names the broadcast decoder's blocks/layers_i layout
    (ocrl_tpu/utils/torch_convert.py:113-124), which migrate_bcdec_tree
    renamed to conv1 / rest: a Slot-Attention file cannot be loaded on
    either side, whatever it holds."""
    ocr = create_ocr(*port_configs([("ocr.use_bcdec", True)]), device="cpu")
    state = reference_state_dict(jax_slate.params)
    message = _both_raise(tmp_path, ocr, state, KeyError)
    assert "no torch mapping for flax param bcdec/conv1/bias" in message


def test_other_ocrs_are_not_implemented(tmp_path):
    ocr = create_ocr(tcfg.VAEConfig(latent_dim=8), tcfg.replace(tcfg.EnvConfig(), "obs_size", 16),
                     device="cpu")
    _both_raise(tmp_path, ocr, {}, NotImplementedError)


def test_a_missing_key_raises_key_error(tmp_path, jax_slate):
    state = reference_state_dict(jax_slate.params)
    del state["_slotattn.slot_mu"]
    ocr = create_ocr(*port_configs(), device="cpu")
    assert "_slotattn.slot_mu" in _both_raise(tmp_path, ocr, state, KeyError)


def test_a_wrong_shape_raises_value_error(tmp_path, jax_slate):
    state = reference_state_dict(jax_slate.params)
    state["_out.weight"] = state["_out.weight"][:, :-1]
    ocr = create_ocr(*port_configs(), device="cpu")
    assert "shape mismatch" in _both_raise(tmp_path, ocr, state, ValueError)


def test_a_pickled_object_is_refused_where_jax_loads_it(tmp_path, jax_slate):
    """The port reads with weights_only=True: a file that also holds a
    pickled object (here an argparse.Namespace, as a training script's
    config) raises UnpicklingError; JAX, with weights_only=False, loads it."""
    path = tmp_path / "with_config.pth"
    write_pth(path, reference_state_dict(jax_slate.params),
              config=argparse.Namespace(lr=1e-4))
    assert jtc.load_reference_checkpoint(path, jax_slate) == BOOKKEEPING
    ocr = create_ocr(*port_configs(), device="cpu")
    before = {k: v.clone() for k, v in ocr.module.state_dict().items()}
    with pytest.raises(pickle.UnpicklingError):
        torch_convert.load_reference_checkpoint(path, ocr)
    for key, v in ocr.module.state_dict().items():
        assert torch.equal(v, before[key]), key
