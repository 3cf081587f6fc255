"""The training slice as a whole: the port's OCR.update against the JAX
package's, at a small width, from the same weights (carried by
utils.convert.ocr_from_flax) and the same draws.

The JAX side builds its OCR with create_ocr and takes its jitted steps with
the Pallas sweep in interpret mode (``ocr.slotattr.fused=auto``); its random
draws are replaced by the test's numpy draws (the two Gumbel fields'
exponentials in call order, the slot noise), and the port is given the same
fields through ``update(..., noise=...)``. Dropout is 0, since the two
frameworks' dropout streams differ; the dropouts are held with given masks
module by module in test_torch_models.py. The JAX step is traced once per
module, with these draws baked in, so every update here uses them.

Tolerances, and why:
- loss and metrics, 1e-5 relative: sums of fp32 convolutions, attention
  and a 3-iteration slot recurrence taken in another order;
- gradients, each leaf to 1e-4 of its own largest entry, plus 1e-7 of the
  largest gradient of the model: a leaf whose gradient is zero in exact
  arithmetic (the bias of ``norm_slots``: adding one vector to every query
  shifts all slots' logits alike) keeps only rounding noise;
- updated parameters, as the change divided by the group's last lr, to
  1e-2: Adam's first steps are near lr * sign(g), so the change amplifies
  the gradients' relative error by the ratio |g| / eps for small |g|.
"""

import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.config import compose
from ocrl_tpu.models import create_ocr as jcreate_ocr
from ocrl_tpu.models import slate as jslate

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.config import read_env_config
from ocrl_tpu_torch.data.collect import collect_dataset
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models.slate import GROUP_OF, group_schedule
from ocrl_tpu_torch.train_ocr import main
from ocrl_tpu_torch.utils.convert import ocr_from_flax

SMALL = [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
         ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
         ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
         ("ocr.dvae.d_model", 32), ("ocr.tfdec.num_dec_blocks", 2),
         ("ocr.tfdec.num_dec_heads", 2), ("ocr.learning.dropout", 0.0)]
B = 2
TINY = np.finfo(np.float32).tiny
TRUE_DRAWS = (jax.random.exponential, jax.random.normal)


def port_configs(over=SMALL):
    cfg = tcfg.PolicyConfig()
    for path, value in over:
        cfg = tcfg.replace(cfg, path, value)
    return cfg.ocr, cfg.env


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    e = [rng.exponential(size=(B * 16, 32)).astype(np.float32) for _ in range(2)]
    slots = rng.standard_normal((B, 3, 32)).astype(np.float32)
    return obs, e, slots


def _patched_jax_ocr(draws, ocr):
    """The JAX OCR ``ocr``, its initial params, and a jitted value-and-grad
    of its training loss; the random draws stay patched until the
    generator is closed."""
    _, e, slots = draws
    calls = []

    def exponential(key, shape, dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(e[(len(calls) - 1) % 2])   # soft field, then ids field

    cfg = compose("train_sb3", [f"ocr={ocr}", "env=target-N4C4S3S1", "pooling=transformer",
                                "sb3=ppo", "sb3_acnet=mlp", "ocr.slotattr.fused=auto"]
                  + [f"{k}={v}" for k, v in SMALL])
    with pytest.MonkeyPatch.context() as mp:    # the true draws, whatever is patched
        mp.setattr(jax.random, "exponential", TRUE_DRAWS[0])
        mp.setattr(jax.random, "normal", TRUE_DRAWS[1])
        jocr = jcreate_ocr(cfg.ocr, cfg.env, seed=0)
    params0 = jax.tree.map(np.asarray, jocr.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "exponential", exponential)
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(slots))
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, obs, step: jocr.spec.module.apply(
                {"params": p}, obs, None, step, True, method="loss",
                rngs=jocr._rngs_for(jax.random.PRNGKey(0))), has_aux=True))
        with jax.default_matmul_precision("highest"):
            yield jocr, params0, grad_fn


@pytest.fixture(scope="module")
def jax_ocr(draws):
    """The JAX SLATE OCR (see ``_patched_jax_ocr``)."""
    yield from _patched_jax_ocr(draws, "slate")


@pytest.fixture(scope="module")
def jax_bcdec_ocr(draws):
    """The JAX Slot-Attention OCR: SLATE with ``use_bcdec``."""
    yield from _patched_jax_ocr(draws, "slotattention")


def reset(jocr, params0):
    jocr.params = jax.tree.map(jnp.asarray, params0)
    jocr.opt_state = jocr.tx.init(jocr.params)


def port_noise(draws):
    _, e, slots = draws
    return {"soft": torch.from_numpy(-np.log(e[0] + TINY)),
            "ids": torch.from_numpy(-np.log(e[1] + TINY)),
            "slots": torch.from_numpy(slots)}


@pytest.mark.parametrize("step,n", [(0, 1), (40000, 2)])
def test_update_matches_jax(jax_ocr, draws, step, n):
    """n consecutive updates from ``step``: every metric of each, the
    clipped gradients of the first, and the parameters after the last.
    From step 40000 the tau anneal and the lr metrics are past warm-up and
    the second update runs on Adam's moments from the first."""
    _check_updates(*jax_ocr, draws, step, n, SMALL)


def test_bcdec_update_matches_jax(jax_bcdec_ocr, draws):
    """One update of the Slot-Attention OCR (``use_bcdec``: the broadcast
    decoder's MSE) under the same rules. The parameters its loss does not
    reach (the dVAE, the transformer decoder) get no gradient in the port
    and a zero one in JAX, and stay where they are in both. The bias of the
    mask logit (``rest.2.bias[3]``) has a zero gradient in exact arithmetic,
    since the masks' softmax over the slots ignores a shift common to all
    slots: its gradient is held like the others, but Adam's first step turns
    the rounding left in it into any change in [-lr, lr], so its change is
    held to that range on both sides instead of to the other's."""
    _check_updates(*jax_bcdec_ocr, draws, 0, 1, SMALL + [("ocr.use_bcdec", True)],
                   zero_in_exact_arithmetic={"bcdec.rest.2.bias": 3})


def _check_updates(jocr, params0, grad_fn, draws, step, n, over,
                   zero_in_exact_arithmetic=None):
    obs = draws[0]
    reset(jocr, params0)
    (_, jmetrics), jgrads = grad_fn(jocr.params, obs.astype(np.float32) / 255.0, step)
    want = [{k: float(v) for k, v in jocr.update(obs, None, step + i).items()}
            for i in range(n)]

    ocr_cfg, env_cfg = port_configs(over)
    ocr = create_ocr(ocr_cfg, env_cfg, seed=1, device="cpu")
    ocr.module.load_state_dict(ocr_from_flax(params0))
    got, grads = [], None
    for i in range(n):
        got.append(ocr.update(obs, None, step + i, noise=port_noise(draws)))
        if i == 0:
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for k, p in ocr.module.named_parameters()}

    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(float(g[key]), w[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(got[0]["loss"]), float(jmetrics["loss"]), rtol=1e-5)

    scale = min(1.0, ocr_cfg.learning.clip / (want[0]["norm"] + 1e-6))
    want_grads = {k: v * scale for k, v in ocr_from_flax(jax.tree.map(np.asarray, jgrads)).items()}
    assert set(grads) == set(want_grads)
    top = max(w.abs().max().item() for w in want_grads.values())
    for key, w in want_grads.items():
        err = (grads[key] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-7 * top, (key, err)

    start = ocr_from_flax(params0)
    after = ocr_from_flax(jax.tree.map(np.asarray, jocr.params))
    lr = {"dvae": ocr_cfg.learning.lr_dvae}
    lr["sa"] = group_schedule(ocr_cfg.learning.lr_enc, ocr_cfg.learning.lr_warmup_steps,
                              ocr_cfg.learning.lr_half_life)(n - 1)
    lr["dec"] = group_schedule(ocr_cfg.learning.lr_dec, ocr_cfg.learning.lr_warmup_steps,
                               ocr_cfg.learning.lr_half_life)(n - 1)
    for key, p in ocr.module.state_dict().items():
        group_lr = lr[GROUP_OF[key.split(".")[0]]]
        moved, want_moved = (p - start[key]) / group_lr, (after[key] - start[key]) / group_lr
        if key in (zero_in_exact_arithmetic or {}):
            i = zero_in_exact_arithmetic[key]
            assert abs(moved[i]) <= 1 + 1e-5 and abs(want_moved[i]) <= 1 + 1e-5, key
            moved[i] = want_moved[i] = 0.0
        np.testing.assert_allclose(moved.numpy(), want_moved.numpy(), atol=1e-2,
                                   err_msg=key)


def test_update_many_equals_updates(draws):
    """update_many(k=2) is two updates, one batch each, on one generator."""
    obs = np.concatenate([draws[0], draws[0][::-1]])
    ocr_cfg, env_cfg = port_configs(SMALL[:-1])        # dropout 0.1 here
    one, many = (create_ocr(ocr_cfg, env_cfg, seed=3, device="cpu") for _ in range(2))
    steps = [one.update(obs[:B], None, 5), one.update(obs[B:], None, 6)]
    stacked = many.update_many(obs, None, 5, 2)
    for key in stacked:
        np.testing.assert_array_equal(
            stacked[key].numpy(), np.array([float(m[key]) for m in steps], np.float32),
            err_msg=key)
    for (name, p), q in zip(one.module.named_parameters(), many.module.parameters()):
        assert torch.equal(p, q), name
    assert one.optimizer.count == many.optimizer.count == 2


def test_update_with_masks_matches_jax(jax_ocr, draws):
    """An update given masks reports the foreground ``ari`` as JAX's does
    (within 1e-6; the other metrics 1e-5 relative, as above)."""
    from test_torch_eval import painted

    jocr, params0, _ = jax_ocr
    obs, masks = draws[0], painted(B, 16, seed=9)[1]
    reset(jocr, params0)
    want = {k: float(v) for k, v in jocr.update(obs, masks, 0).items()}
    ocr = create_ocr(*port_configs(), seed=1, device="cpu")
    ocr.module.load_state_dict(ocr_from_flax(params0))
    got = ocr.update(obs, masks, 0, noise=port_noise(draws))
    assert set(got) == set(want) and "ari" in got
    np.testing.assert_allclose(float(got["ari"]), want["ari"], rtol=0, atol=1e-6)
    for key in set(want) - {"ari"}:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=key)


def test_update_many_passes_masks(draws):
    """update_many(k=2) with masks is two updates with a batch of masks each."""
    from test_torch_eval import painted

    obs = np.concatenate([draws[0], draws[0][::-1]])
    masks = painted(2 * B, 16, seed=10)[1]
    one, many = (create_ocr(*port_configs(), seed=3, device="cpu") for _ in range(2))
    steps = [one.update(obs[:B], masks[:B], 5), one.update(obs[B:], masks[B:], 6)]
    stacked = many.update_many(obs, masks, 5, 2)
    assert "ari" in stacked
    for key in stacked:
        np.testing.assert_array_equal(
            stacked[key].numpy(), np.array([float(m[key]) for m in steps], np.float32),
            err_msg=key)


@pytest.mark.parametrize("count", [0, 1, 29998, 29999, 30000, 250000])
def test_group_schedules_match_optax(count):
    """The sa / dec learning rates at optax's count (0 at the first update)."""
    lr = port_configs()[0].learning
    for base in (lr.lr_enc, lr.lr_dec):
        want = jslate._group_schedule(base, lr.lr_warmup_steps, lr.lr_half_life)(count)
        got = group_schedule(base, lr.lr_warmup_steps, lr.lr_half_life)(count)
        np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_every_parameter_has_its_group():
    assert GROUP_OF == jslate._GROUP_OF
    ocr = create_ocr(*port_configs(), seed=0, device="cpu")
    groups = {g["group"]: len(g["params"]) for g in ocr.optimizer.adam.param_groups}
    assert sum(groups.values()) == len(list(ocr.module.parameters()))
    assert all(groups.values())


def test_clip_matches_jax():
    """The inf-norm clip over all groups together, with its 1e-6."""
    from ocrl_tpu.models.base import clip_by_total_norm as jclip
    from ocrl_tpu_torch.models.base import clip_by_total_norm

    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": (rng.standard_normal(5) * 3).astype(np.float32)}
    want, _ = jclip(0.05).update(grads, None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads.values()]
    for p, g in zip(params, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_total_norm(params, 0.05)
    np.testing.assert_allclose(norm.item(), max(np.abs(g).max() for g in grads.values()))
    for p, w in zip(params, want.values()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_save_and_load_resume_the_same_run(draws):
    obs = draws[0]
    a = create_ocr(*port_configs(), seed=5, device="cpu")
    a.update(obs, None, 0)
    buffer = io.BytesIO()
    torch.save(a.save(), buffer)
    buffer.seek(0)
    ckpt = torch.load(buffer)
    b = create_ocr(*port_configs(), seed=6, device="cpu")
    b.load(ckpt)
    noise = port_noise(draws)
    want, got = a.update(obs, None, 1, noise=dict(noise)), b.update(obs, None, 1, noise=dict(noise))
    np.testing.assert_array_equal(float(got["loss"]), float(want["loss"]))
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(p, q)


def test_create_ocr_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_ocr(*port_configs())


def test_train_drives_update_many(tmp_path):
    """train_ocr.main in superbatches of k = 4 on a collected file: one
    record of finite metrics per step, the loss falls, and ``profile_dir``
    gets a torch.profiler trace of steps 12-19."""
    collect_dataset(tcfg.replace(read_env_config("random-N5C4S4S2"), "obs_size", 16), 16, 2,
                    out_file=tmp_path / "ds.hdf5")
    over = [f"{'dataset' if k.startswith('env.') else 'ocr'}.{k.split('.', 1)[1]}={v}"
            for k, v in SMALL]
    result = main(["ocr=slate", "dataset=random-N5C4S4S2", f"dataset.datadir={tmp_path}/ds.hdf5",
                   "batch_size=2", "superbatch=4", "eval_interval=100", "log_interval=4",
                   "max_steps=20", f"run_dir={tmp_path}/run", "ocr.learning.lr_warmup_steps=1",
                   f"profile_dir={tmp_path}/trace"] + over, device="cpu")
    assert result["step"] == 20
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    records = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    losses = {r["_step"]: r["train/loss"] for r in records if "train/loss" in r}
    assert sorted(losses) == list(range(20)) and all(np.isfinite(v) for v in losses.values())
    assert np.mean([losses[s] for s in range(16, 20)]) < np.mean([losses[s] for s in range(4)])
