"""The harness on the CPU at a small size: the result line's shape, the
reference against the port, the faults the check must catch, the files
every entry of BENCHMARK.json needs, and no JAX module anywhere."""

from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchcore import main as harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PRETRAIN = ["slotattention.pretrain.b64"]
CELLS = PRETRAIN + ["slate.sac.b256"]
# full structure, small widths: the dVAE keeps its 64 channels
SMALL = dict(obs_size=16, cnn_hidden_size=16, slot_size=32, mlp_hidden_size=32,
             vocab_size=32, d_model=32)
SMALL_TRAFFIC = dict(batch_size=4, superbatch=4, train_scenes=64, val_scenes=8,
                     warmup_superbatches=2, trace_superbatches=1)
# the CausalWorld envs render 64 x 64 whatever the config says; the heads
# and the pooling's feed-forward keep their fixed widths
SMALL_RL = dict(cnn_hidden_size=16, num_slots=3, slot_size=32, mlp_hidden_size=32,
                pool_d_model=32, pool_nhead=4)
SMALL_RL_TRAFFIC = dict(num_envs=2, vec_env="dummy", batch_size=8, buffer_size=200,
                        learning_starts=20, warmup_updates=2, trace_steps=3)


def small(workload: str) -> dict:
    if workload in PRETRAIN:
        return dict(m_overrides=SMALL, traffic_overrides=SMALL_TRAFFIC)
    return dict(m_overrides=SMALL_RL, traffic_overrides=SMALL_RL_TRAFFIC)


def small_run(workload: str, trace: bool = False, tmp_path=None):
    return harness.run_cell(workload, 2 ** 31 + 17, 0.5, trace, time.time(), device="cpu",
                            workdir=tmp_path, **small(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_untraced(workload, tmp_path):
    result, lines = small_run(workload, False, tmp_path)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(BENCH, workload, "end_to_end")}
    assert set(result["metrics"]) == names
    for value in result["metrics"].values():
        assert set(value) == {"value", "unit"} and value["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = json.loads((ROOT / "benchmark" / "cells" / f"{workload}.json").read_text())
    assert set(result["checks"]) == set(limits["limits"])
    assert lines[0].startswith("setup phases (s): imports ")
    assert [line.split(":")[0] for line in lines[1:]] == [f"check {k}" for k in result["checks"]]
    json.dumps(result)


@pytest.mark.parametrize("workload,host_metrics", [
    ("slotattention.pretrain.b64", {"loader_wait_ms.pretrain"}),
    ("slate.sac.b256", {"env_step_ms.rl", "sac_update_ms.rl"})])
def test_result_line_traced(workload, host_metrics, tmp_path):
    result, _ = small_run(workload, True, tmp_path)
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert result["correct"] is True
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    # on the CPU only the host-clock readers find something to read
    assert set(result["metrics"]) == host_metrics


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_port(workload, tmp_path):
    _, _, runner, ctx = harness.make_context(workload, 5, 0.0, False, time.time(),
                                             device="cpu", workdir=tmp_path, **small(workload))
    got = runner.readings(ctx, faults=True)
    assert got["program"]["loss_gap"] < 1e-6
    assert got["program"]["grad_gap"] < 1e-5
    assert got["program"]["change_gap"] < 1e-3
    # the half batch fails the limits of the full-size cell
    assert any(got["half_batch"][k] > ctx.limits[k] for k in ctx.limits)


def _break_adam(monkeypatch):
    """A step that returns its state unchanged: Adam counts and moves nothing."""
    from ocrl_tpu_torch.models.base import MultiGroupAdam
    from ocrl_tpu_torch.rl.ppo import OptaxChain

    def step(self, *args):
        self.count += 1
    monkeypatch.setattr(MultiGroupAdam, "step", step)
    monkeypatch.setattr(OptaxChain, "step", step)


def _half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from ocrl_tpu_torch.models.base import OCR
    from ocrl_tpu_torch.rl.sac import SAC

    inner, update = OCR._step, SAC.update

    def step(self, obs, masks, step, noise):
        return inner(self, obs[:obs.shape[0] // 2], masks, step, noise)

    def half_update(self, data, noise=None):
        return update(self, {k: v[:v.shape[0] // 2] for k, v in data.items()}, noise)
    monkeypatch.setattr(OCR, "_step", step)
    monkeypatch.setattr(SAC, "update", half_update)


@pytest.mark.parametrize("fault", [_break_adam, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    result, _ = small_run(workload, False, tmp_path)
    assert result["correct"] is False


def test_every_entry_has_its_files():
    for config in BENCH["configs"]:
        path = ROOT / config["file"]
        assert path.is_file() and path.with_suffix(".py").is_file()
        assert path.parts[-3:-1] == ("benchmark", "configs")
    for cell in BENCH["workloads"]:
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        assert (ROOT / "benchmark" / "runners" / f"{traffic['runner']}.py").is_file()
        assert (ROOT / "benchmark" / "cells" / f"{cell['name']}.json").is_file()
    for metric in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in [c for e in BENCH["end_to_end"] if e["name"] == m["moves"]
                         for c in e.get("workloads", cells)]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert 2 + 14 * 24 * 1 <= 43200 and (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 2 * 90 + 1200 <= 43200


def test_forbidden_modules_are_named_by_their_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ocrl_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "ocrl_tpu.models", sys)
    assert harness.forbidden_modules() == ["jax.numpy", "ocrl_tpu.models"]


def test_no_jax_in_a_run():
    """A small run in a fresh process loads no JAX module, the port
    included."""
    code = ("import sys, time; sys.path[:0] = [%r, %r]\n"
            "from benchcore import main as h\n"
            "h.run_cell('slotattention.pretrain.b64', 3, 0.2, True, time.time(), device='cpu',"
            " m_overrides=%r, traffic_overrides=%r)\n"
            "print(h.forbidden_modules())\n"
            "assert 'ocrl_tpu_torch' in sys.modules\n"
            % (str(ROOT / "benchmark"), str(ROOT), SMALL, SMALL_TRAFFIC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "math", "statistics", "__future__", "importlib", "pathlib",
               "benchcore", "benchref"}
    files = list((ROOT / "benchmark" / "benchref").glob("*.py"))
    files += list((ROOT / "benchmark" / "configs").glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] if node.level == 0 else []
            else:
                continue
            assert set(tops) <= allowed, (path, tops)


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "slotattention.pretrain.b64", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


# a quarter of each cell's batch, the widths as the cell runs them
CARD_SIZE = {"slotattention.pretrain.b64": dict(batch_size=16, train_scenes=1024),
             "slate.sac.b256": dict(batch_size=64, learning_starts=200)}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits_on_the_card(workload, tmp_path):
    """The reference computed in TF32, put in the program's place, at the
    cell's widths and a quarter of its batch, fails one of the limits, and
    the program passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, runner, ctx = harness.make_context(workload, 7, 0.0, False, time.time(),
                                             workdir=tmp_path,
                                             traffic_overrides=CARD_SIZE[workload])
    got = runner.readings(ctx, faults=True)
    assert all(got["program"][k] <= ctx.limits[k] for k in ctx.limits)
    assert any(got["control"][k] > ctx.limits[k] for k in ctx.limits)
    assert math.isfinite(got["control"]["loss_gap"])
