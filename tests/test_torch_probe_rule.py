"""The rule by which chip_smoke.py's probes phase holds a first Adam step
card against CPU (``check_property_step``, ``check_classifier_step``), on the
CPU at small SLATE widths (obs 16, 5 slots of 32, as tests/test_torch_probes.py).

An entry's first Adam step is sign-like (g / (|g| + eps)), so it is held to
PROBE_TOL only where the data set the gradient's sign and size: where a
float64 replay of the same CPU step (same batch, slot noise and encoder
features; the pooling, head and loss in float64) clears PRETRAIN_SURE of its
leaf's largest and STEP_GRAD_FLOOR of the model's, and the fp32 gradient
lies within half of it (``chip_smoke.sure_entries``). Every other entry is
held to Adam's bound lr. The float64 replays must give the steps' own
gradients (to 1e-4 of each leaf's largest entry, fp32 against float64)."""

import numpy as np
import pytest
import torch

import chip_smoke
from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import train_classifier
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.poolings import Pooling
from ocrl_tpu_torch.utils import property_predictor as tpp

ARGV = ["ocr=slate", "ocr.cnn.hidden_size=16", "ocr.slotattr.num_slots=5",
        "ocr.slotattr.slot_size=32", "ocr.slotattr.mlp_hidden_size=32",
        "ocr.dvae.vocab_size=32", "ocr.dvae.d_model=32", "ocr.tfdec.num_dec_blocks=2",
        "ocr.tfdec.num_dec_heads=2", "dataset=target-N4C4S3S1", "dataset.obs_size=16"]
B = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: tier-1 runs six workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sure_entries_follow_the_float64_gradient():
    """Sure in fp32 and in float64 with the fp32 gradient within half of
    the float64 one: sure. A sign set by rounding (the float64 gradient of
    the other sign), or an fp32 gradient more than half off: moved out. A
    float64 gradient under the thresholds: moved out, however large the fp32
    one. Without a float64 run, the fp32 rule alone."""
    g32 = {"w": np.array([1.0, 0.9, 1e-3, -1.2e-3, 0.4, 1e-9], np.float32),
           "b": np.array([0.5, 1e-4], np.float32)}
    g64 = {"w": np.array([1.0, 1.0, -1e-3, -1e-3, 1.0, 1e-9]),
           "b": np.array([0.5, 1e-12])}
    fp32, moved = chip_smoke.sure_entries(g32)
    assert moved == {}
    assert fp32["w"].tolist() == [True, True, True, True, True, False]
    assert fp32["b"].tolist() == [True, True]
    sure, moved = chip_smoke.sure_entries(g32, g64)
    assert sure["w"].tolist() == [True, True, False, True, False, False]
    assert sure["b"].tolist() == [True, False]
    assert moved == {"w": 2, "b": 1}
    text, ok = chip_smoke.moved_line(moved, {"w": 6, "b": 2})
    assert not ok and "3 entries" in text and "1 of 2 in b" in text
    assert chip_smoke.moved_line({"w": 1, "b": 0}, {"w": 100, "b": 2})[1]


def _grads32(named, optimizer) -> dict:
    """The step's fp32 gradient as the checks read it: mu / (1 - b1)."""
    side = chip_smoke.adam_side(named, optimizer)
    return {n: m / (1 - 0.9) for n, m in side["mu"].items()}


@pytest.mark.parametrize("probe", ["property", "classifier"])
def test_float64_replays_give_the_steps_gradient(probe):
    """property_grads64 and classifier_grads64 replay one CPU step in float64
    from its starting parameters: by name, every leaf of the head (and the
    pooling) within 1e-4 of its largest entry plus 1e-6 of the model's of
    the fp32 step's own gradient, and the float64 rule moves at most
    MOVED_SHARE of any leaf out of the fp32 rule's sure entries."""
    rng = np.random.default_rng(5)
    batch = {"obss": rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8),
             "objs": np.concatenate([rng.integers(0, 7, (B, 4, 1)), rng.integers(0, 4, (B, 4, 1)),
                                     rng.integers(0, 2, (B, 4, 1)), rng.random((B, 4, 2))],
                                    -1).astype(np.float32),
             "labels": (np.arange(B, dtype=np.int32)[:, None] % 4)}
    if probe == "property":
        cfg = tcfg.compose(tcfg.TrainPropertyPredictorConfig(), ARGV)
    else:
        cfg = tcfg.compose(tcfg.TrainClassifierConfig(),
                           ARGV + ["pooling=transformer", "pooling.d_model=32", "pooling.nhead=4"])
    ocr = create_ocr(cfg.ocr, cfg.dataset, seed=0, device="cpu")
    noise = chip_smoke.slot_noise(cfg, B, 16)
    if probe == "property":
        model = tpp.PropertyPredictor(ocr, cfg.property_predictor, cfg.dataset, seed=0)
        named = list(model.head.named_parameters())
        init = {n: p.detach().numpy().copy() for n, p in named}
        matched = []
        model.update(batch, 0, noise={"rep": torch.from_numpy(noise)}, matched=matched)
        grads64 = chip_smoke.property_grads64(model, init, batch, noise, matched[0])
    else:
        model = train_classifier.Classifier(Pooling(ocr, cfg.pooling, seed=0), ocr, 16, 4,
                                            1e-4, seed=0)
        named = list(model.pooling.named_parameters()) + \
            [(f"head.{n}", p) for n, p in model.head.named_parameters()]
        init = {n: p.detach().numpy().copy() for n, p in named}
        model.step(batch, noise={"rep": torch.from_numpy(noise)})
        grads64 = chip_smoke.classifier_grads64(model, init, batch, noise)
    grads = _grads32(named, model.optimizer)
    assert grads64.keys() == grads.keys() == init.keys()
    top = max(np.abs(g).max() for g in grads64.values())
    for name, g in grads.items():
        assert grads64[name].dtype == np.float64 and grads64[name].shape == g.shape
        scale = 1e-4 * np.abs(grads64[name]).max() + 1e-6 * top
        assert np.abs(g - grads64[name]).max() <= scale, name
    _, moved = chip_smoke.sure_entries(grads, grads64)
    assert chip_smoke.moved_line(moved, {n: v.size for n, v in init.items()})[1]
