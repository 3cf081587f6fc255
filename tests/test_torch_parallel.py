"""Data parallelism (ocrl_tpu_torch.parallel) on the CPU: two gloo ranks
under ``shard_ocr`` against the single-process port at the same global
batch and draws, and their first SLATE and Slot-Attention steps against
JAX's ``shard_ocr`` on a 2-device mesh.

One spawn of two ranks runs every sharded check and writes what it saw to
files; the parent compares. The ranks start from different seeds, so the
step only agrees if ``shard_ocr`` gave rank 1 rank 0's state. The SMALL
SLATE of tests/test_torch_train.py, a global batch of 4 (2 a rank); the
draws are numpy arrays for the whole batch (the Gumbel fields, the slot
noise), each rank given its rows. Cases:
- ``slate`` and ``slotattention`` (``use_bcdec``), dropout 0: two updates,
  the second with masks, an ``update_many`` of k = 2, ``get_loss`` with
  masks, ``rep`` and ``get_samples``; then a save on rank 0 that every rank
  loads;
- ``dropout``: SLATE with dropout 0.1 and no given draws: each rank draws
  the soft and id fields, the slot noise and every dropout mask itself, and
  they are its rows of what one process draws;
- ``vae``, ``mae`` and ``iodine`` (small widths), no given draws: the
  VAE's eps, MAE's masking order and IODINE's eps (batch axis 1) are each
  rank's rows of one process's, and the step is one process's.

Tolerances, as tests/test_torch_train.py states them: metrics 1e-5
relative (the ARI 1e-6 absolute); gradients each leaf to 1e-4 of its own
largest entry plus 1e-7 of the model's largest; parameters as their change
over the group's lr, to 1e-2, but for the bias of the broadcast decoder's
mask logit (``bcdec.rest.2.bias[3]``): its gradient is zero in exact
arithmetic (the masks' softmax over the slots ignores a shift common to
all slots), and Adam turns the rounding left in it into any step in
[-lr, lr], so its change is held to that range a step on both sides, as
tests/test_torch_train.py holds it. Gloo sums the two halves in another
order than one process does, so only rounding differs; the ranks among
themselves are bitwise equal.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.data.prefetch import prefetch_to_device
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.parallel import local_rows, make_group, shard_ocr
from ocrl_tpu_torch.utils import checkpoint as ckpt

SMALL = [("env.obs_size", 16), ("ocr.cnn.hidden_size", 16),
         ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
         ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
         ("ocr.dvae.d_model", 32), ("ocr.tfdec.num_dec_blocks", 2),
         ("ocr.tfdec.num_dec_heads", 2), ("ocr.learning.dropout", 0.0)]
CASES = {"slate": SMALL, "slotattention": SMALL + [("ocr.use_bcdec", True)],
         "dropout": SMALL[:-1] + [("ocr.learning.dropout", 0.1)]}
OTHER_OCRS = {"vae": ("VAEConfig", {"latent_dim": 16}),
              "mae": ("MAEConfig", {"vit_size": "tiny", "patch_size": 4}),
              "iodine": ("IodineConfig", {"slot_size": 8, "num_iterations": 2,
                                          "ref_cnn_hidden_size": 16, "ref_mlp_hidden_size": 32,
                                          "dec_cnn_hidden_size": 16})}
# the batch axis of a case's recorded draws (IODINE's eps is [iterations, B, K, L])
BATCH_AXIS = {"iodine": 1}
DRIVEN = ("slate", "slotattention")
ALL_CASES = list(CASES) + list(OTHER_OCRS)          # the driven cases first
B, WORLD, K = 4, 2, 2
STEPS = 2 + K                       # the optimizer steps each driven case takes
ZERO_IN_EXACT_ARITHMETIC = {"bcdec.rest.2.bias": 3}
TINY = np.finfo(np.float32).tiny
SPAWN_SECONDS = 600      # a deadline against a hang, far above the ranks' time under load
SEED = 11


def port_configs(case):
    """(OCR config, env config) of a case at obs 16."""
    if case in OTHER_OCRS:
        cls, fields = OTHER_OCRS[case]
        return getattr(tcfg, cls)(**fields), tcfg.EnvConfig(obs_size=16)
    cfg = tcfg.PolicyConfig()
    for path, value in CASES[case]:
        cfg = tcfg.replace(cfg, path, value)
    return cfg.ocr, cfg.env


def make_data() -> dict:
    """The global batches, masks and draws, numpy, from one seed."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, (3 * B, 16, 16))
    masks = (labels[:, None] == np.arange(5)[None, :, None, None])[..., None]
    noise = [{"e_soft": rng.exponential(size=(B * 16, 32)).astype(np.float32),
              "e_ids": rng.exponential(size=(B * 16, 32)).astype(np.float32),
              "slots": rng.standard_normal((B, 3, 32)).astype(np.float32)}
             for _ in range(4)]
    return {"obs": rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8),
            "obs2": rng.integers(0, 256, (K * B, 16, 16, 3), dtype=np.uint8),
            "masks": masks[:B].astype(np.uint8), "masks2": masks[B:].astype(np.uint8),
            "noise": noise}


def port_noise(draws: dict, take) -> dict:
    return {"soft": torch.from_numpy(take(-np.log(draws["e_soft"] + TINY))),
            "ids": torch.from_numpy(take(-np.log(draws["e_ids"] + TINY))),
            "slots": torch.from_numpy(take(draws["slots"]))}


def floats(metrics: dict) -> dict:
    return {k: torch.as_tensor(v).double().numpy() for k, v in metrics.items()}


def drive(ocr, data: dict, take) -> dict:
    """The sharded calls of one case; ``take(x, batches)`` gives the rows
    this process holds (all of them in one process)."""
    out = {"m": [floats(ocr.update(take(data["obs"]), None, 0,
                                   noise=port_noise(data["noise"][0], take)))]}
    out["grads"] = {n: p.grad.clone() for n, p in ocr.module.named_parameters()
                    if p.grad is not None}
    out["m"].append(floats(ocr.update(take(data["obs"]), take(data["masks"]), 1,
                                      noise=port_noise(data["noise"][1], take))))
    out["m"].append(floats(ocr.update_many(take(data["obs2"], K), take(data["masks2"], K), 2,
                                           K, noise=port_noise(data["noise"][2], take))))
    out["params"] = {k: v.clone() for k, v in ocr.module.state_dict().items()}
    out["eval"] = floats(ocr.get_loss(take(data["obs"]), take(data["masks"]),
                                      noise=port_noise(data["noise"][3], take)))
    out["rep"] = ocr.rep(take(data["obs"]),
                         noise={"rep": torch.from_numpy(take(data["noise"][3]["slots"]))})
    out["samples"] = ocr.get_samples(take(data["obs"]))["samples"]
    return out


def drawn_step(ocr, data: dict, take) -> dict:
    drawn = {}
    metrics = floats(ocr.update(take(data["obs"]), None, 0, noise=drawn))
    return {"m": [metrics], "drawn": drawn,
            "params": {k: v.clone() for k, v in ocr.module.state_dict().items()},
            "grads": {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for n, p in ocr.module.named_parameters()}}


def _ranks(rank: int, init: str, out_dir: str, data: dict) -> None:
    """One rank: every case under shard_ocr, results to ``out_dir``. Rank 0
    makes each OCR from SEED, the state one process starts from; rank 1
    from another seed, which shard_ocr must overwrite."""
    torch.set_num_threads(1)
    group = make_group("gloo", rank, WORLD, init)
    take = lambda x, batches=1: local_rows(x, (rank, WORLD), batches)  # noqa: E731
    for case in ALL_CASES:
        ocr = create_ocr(*port_configs(case), seed=SEED + rank, device="cpu")
        shard_ocr(ocr, group)
        out = drive(ocr, data, take) if case in DRIVEN else drawn_step(ocr, data, take)
        if case == "slate":
            ckpt.save(ocr, os.path.join(out_dir, "run"), step=4)
            fresh = create_ocr(*port_configs(case), seed=5, device="cpu")
            ckpt.load(fresh, os.path.join(out_dir, "run"))
            out["loaded"] = {k: v.clone() for k, v in fresh.module.state_dict().items()}
        torch.save(out, os.path.join(out_dir, f"{case}-{rank}.pt"))
    dist.destroy_process_group()


def jax_first_step(data: dict) -> dict:
    """The metrics of the first step of each driven case (SLATE, and
    Slot-Attention: SLATE with ``use_bcdec``) under JAX's shard_ocr on a
    2-device mesh, from the port's initial state (SEED, carried by
    ``ocr_to_flax``), the draws patched to the test's arrays."""
    import jax
    import jax.numpy as jnp

    from ocrl_tpu.config import compose
    from ocrl_tpu.models import create_ocr as jcreate_ocr
    from ocrl_tpu.parallel import batch_sharding, make_mesh
    from ocrl_tpu.parallel import shard_ocr as jshard_ocr

    from ocrl_tpu_torch.utils.convert import attention_heads, ocr_to_flax
    from test_torch_train import SMALL as TRAIN_SMALL

    assert SMALL == TRAIN_SMALL
    draws = data["noise"][0]
    mesh = make_mesh(WORLD)
    out = {}
    for case in DRIVEN:
        cfg = compose("train_sb3", [f"ocr={case}", "env=target-N4C4S3S1",
                                    "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
                                    "ocr.slotattr.fused=auto"]
                      + [f"{k}={v}" for k, v in SMALL])
        jocr = jcreate_ocr(cfg.ocr, cfg.env, seed=0)
        module = create_ocr(*port_configs(case), seed=SEED, device="cpu").module
        jocr.params = jax.tree.map(jnp.asarray, ocr_to_flax(module.state_dict(),
                                                            attention_heads(module)))
        jocr.opt_state = jocr.tx.init(jocr.params)
        jshard_ocr(jocr, mesh)
        calls = []

        def exponential(key, shape, dtype=jnp.float32):
            calls.append(shape)
            return jnp.asarray(draws["e_soft" if len(calls) % 2 else "e_ids"])

        with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
            mp.setattr(jax.random, "exponential", exponential)
            mp.setattr(jax.random, "normal",
                       lambda key, shape, dtype=jnp.float32: jnp.asarray(draws["slots"]))
            metrics = jocr.update(jax.device_put(data["obs"], batch_sharding(mesh)), None, 0)
        out[case] = {k: float(v) for k, v in metrics.items()}
    return out


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """({case: [rank 0's results, rank 1's]} of one spawn of two ranks,
    {case: the metrics of JAX's sharded first step}), JAX's jit compiling while the
    ranks run. A rank that fails, or ranks that outlive SPAWN_SECONDS
    (killed), fail the test instead of hanging it."""
    out_dir = tmp_path_factory.mktemp("ranks")
    context = torch.multiprocessing.start_processes(
        _ranks, (f"file://{out_dir}/init", str(out_dir), data), nprocs=WORLD, join=False,
        start_method="spawn")
    deadline = time.monotonic() + SPAWN_SECONDS
    try:
        jax_metrics = jax_first_step(data)
        while not context.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {SPAWN_SECONDS} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
    ranks = {case: [torch.load(out_dir / f"{case}-{r}.pt", weights_only=False)
                    for r in range(WORLD)] for case in ALL_CASES}
    return ranks, jax_metrics


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(data):
    """The same calls in one process at the global batch, from SEED."""
    take = lambda x, batches=1: x  # noqa: E731
    out = {}
    for case in ALL_CASES:
        ocr = create_ocr(*port_configs(case), seed=SEED, device="cpu")
        start = {k: v.clone() for k, v in ocr.module.state_dict().items()}
        out[case] = drive(ocr, data, take) if case in DRIVEN else drawn_step(ocr, data, take)
        out[case]["start"] = start
        lrs = {id(p): (g["lr"], g["weight_decay"]) for g in ocr.optimizer.adam.param_groups
               for p in g["params"]}
        out[case]["lr"] = {n: lrs[id(p)] for n, p in ocr.module.named_parameters()}
    return out


def check_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "ari":
            np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)


def check_params(got: dict, want: dict, start: dict, lr: dict, steps: int,
                 grads: dict | None = None) -> None:
    """The change of each parameter over its group's last lr, to 1e-2. Held
    within ``steps`` lr (1 + weight decay |p|) on both sides instead: the entry of
    ZERO_IN_EXACT_ARITHMETIC and, given one process's ``grads`` of a first
    step, every entry whose gradient is below 1e-4 of its leaf's largest
    or 1e-6 of the model's (an attention's key bias has none in exact
    arithmetic; Adam's first step turns its rounding into any move up to
    lr, as chip_smoke.first_step_gap holds it)."""
    top = None if grads is None else max(g.abs().max().item() for g in grads.values())
    for key, w in want.items():
        if key not in lr:
            assert torch.equal(got[key], w), key       # a buffer
            continue
        group_lr, decay = lr[key]
        moved, want_moved = (got[key] - start[key]) / group_lr, (w - start[key]) / group_lr
        noisy = torch.zeros_like(moved, dtype=torch.bool)
        if key in ZERO_IN_EXACT_ARITHMETIC:
            noisy.view(-1)[ZERO_IN_EXACT_ARITHMETIC[key]] = True
        if grads is not None:
            g = grads[key].abs()
            noisy |= (g <= 1e-4 * g.max()) | (g <= 1e-6 * top)
        bound = (steps * (1 + decay * start[key].abs()) * (1 + 1e-3)
                 + torch.finfo(torch.float32).eps * start[key].abs() / group_lr)
        assert (moved.abs() <= bound)[noisy].all(), key
        assert (want_moved.abs() <= bound)[noisy].all(), key
        moved[noisy] = want_moved[noisy] = 0.0
        np.testing.assert_allclose(moved.numpy(), want_moved.numpy(), atol=1e-2, err_msg=key)


@pytest.mark.parametrize("case", DRIVEN)
def test_sharded_calls_match_one_process(ranks, single, case):
    """Every metric of the two updates, update_many and get_loss, the first
    step's clipped gradients and the parameters after four steps: each
    rank's against one process's at the global batch; ``rep`` is each
    rank's rows of one process's; ``get_samples`` the grid of the whole
    batch on every rank."""
    want = single[case]
    for got in ranks[case]:
        for g, w in zip(got["m"] + [got["eval"]], want["m"] + [want["eval"]]):
            check_metrics(g, w)
        assert set(got["grads"]) == set(want["grads"])
        top = max(w.abs().max().item() for w in want["grads"].values())
        for key, w in want["grads"].items():
            err = (got["grads"][key] - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item() + 1e-7 * top, (key, err)
        check_params(got["params"], want["params"], want["start"], want["lr"], STEPS)
        assert got["samples"].shape == want["samples"].shape
    rep = torch.cat([got["rep"] for got in ranks[case]])
    scale = want["rep"].abs().max().item()
    assert (rep - want["rep"]).abs().max().item() <= 1e-5 * scale
    # sample grids (uint8): images of rounded floats; the greedy tokens agree
    diff = np.abs(ranks[case][0]["samples"].astype(int) - want["samples"].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


@pytest.mark.parametrize("case", ALL_CASES)
def test_ranks_stay_bitwise_equal(ranks, case):
    """The ranks' metrics, parameters and (where gathered) sample grids are
    bitwise equal: one all-reduce gives every rank the same gradients."""
    a, b = ranks[case]
    for ma, mb in zip(a["m"], b["m"]):
        for key in ma:
            np.testing.assert_array_equal(ma[key], mb[key], err_msg=key)
    for key, p in a["params"].items():
        assert torch.equal(p, b["params"][key]), key
    if case in DRIVEN:
        np.testing.assert_array_equal(a["samples"], b["samples"])


@pytest.mark.parametrize("case", DRIVEN)
def test_first_sharded_step_matches_jax_shard_ocr(runs, case):
    """The first step of the two ranks (SLATE, Slot-Attention) against
    JAX's sharded step on a 2-device mesh with the same weights and draws:
    loss and metrics to 1e-5 relative (JAX's own check holds its sharded
    loss to 1e-4 of its single-device loss, tests/test_parallel.py)."""
    ranks, jax_metrics = runs
    want = jax_metrics[case]
    for got in ranks[case]:
        assert set(got["m"][0]) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(got["m"][0][key], w, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("case,keys", [("dropout", {"soft", "ids", "slots"}),
                                       ("vae", {"eps"}), ("mae", {"masking"}),
                                       ("iodine", {"eps"})])
def test_drawn_noise_is_each_ranks_rows_of_one_process(ranks, single, case, keys):
    """Without given draws each rank draws its rows, on the draw's batch
    axis, of what one process draws for the whole batch, bitwise (SLATE's
    fields and slot noise, the VAE's eps, MAE's masking order, IODINE's
    eps), and with them (and SLATE's dropout masks) takes one process's
    step."""
    want = single[case]
    for rank, got in enumerate(ranks[case]):
        assert set(got["drawn"]) == set(want["drawn"]) == keys
        for key, w in want["drawn"].items():
            axis = BATCH_AXIS.get(case, 0)
            n = w.shape[axis] // WORLD
            assert torch.equal(got["drawn"][key], w.narrow(axis, rank * n, n)), key
        check_metrics(got["m"][0], want["m"][0])
        check_params(got["params"], want["params"], want["start"], want["lr"], 1,
                     want["grads"])


def test_a_direct_module_call_draws_the_ranks_rows():
    """The shard rides on the OCR's generator, so a caller that runs
    ``ocr.module`` itself with ``ocr.generator`` (as poolings/wrapper.py
    does) draws the rank's rows of one process's draw too, not a draw at
    the local shape."""
    from ocrl_tpu_torch.models.common import shard_draws

    obs = torch.from_numpy(make_data()["obs"]).float() / 255.0
    want = {}
    one = create_ocr(*port_configs("vae"), seed=SEED, device="cpu")
    one.module.loss(obs, None, 0, True, generator=one.generator, noise=want)
    for rank in range(WORLD):
        ocr = create_ocr(*port_configs("vae"), seed=SEED, device="cpu")
        shard_draws(ocr.generator, (rank, WORLD))
        got = {}
        ocr.module.loss(local_rows(obs, (rank, WORLD)), None, 0, True,
                        generator=ocr.generator, noise=got)
        assert torch.equal(got["eps"], local_rows(want["eps"], (rank, WORLD)))
        assert torch.equal(ocr.generator.get_state(), one.generator.get_state())


def test_rank_0_saves_and_every_rank_loads(ranks):
    for got in ranks["slate"]:
        for key, p in got["params"].items():
            assert torch.equal(got["loaded"][key], p), key


def test_local_rows_split_each_batch():
    x = np.arange(2 * 6).reshape(2 * 6, 1)
    assert local_rows(x, (1, 3))[:, 0].tolist() == [4, 5, 6, 7]
    assert local_rows(x, (1, 3), batches=2)[:, 0].tolist() == [2, 3, 8, 9]
    with pytest.raises(ValueError, match="does not split"):
        local_rows(x, (0, 5))
    with pytest.raises(ValueError, match="not 5 batches"):
        local_rows(x, (0, 2), batches=5)


def test_prefetch_with_a_shard_yields_the_ranks_rows():
    """The counterpart of the JAX prefetch's ``sharding``: each batch as the
    rank's rows; a batch the ranks do not divide, or a superbatch, raises."""
    batches = [{"obss": np.arange(8 * 2).reshape(8, 2) + 100 * i} for i in range(3)]
    got = list(prefetch_to_device(iter(batches), "cpu", shard=(1, 4)))
    assert [b["obss"].tolist() for b in got] == [b["obss"][2:4].tolist() for b in batches]
    with pytest.raises(ValueError, match="does not split"):
        list(prefetch_to_device(iter(batches), "cpu", shard=(0, 3)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        list(prefetch_to_device(iter(batches), "cpu", superbatch=2, shard=(0, 2)))


def test_make_group_takes_no_backend_it_does_not_know():
    with pytest.raises(ValueError, match="backend"):
        make_group("mpi", 0, 1, "file:///nonexistent")
