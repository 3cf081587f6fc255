"""``benchcore.program``, the program's own spans in a traced window: its
readings on hand-built Chrome-trace events, the harness's own readers and
``breakdown`` unmoved by the program's ranges and the ``cuda_driver`` launch
records, and the port's spans inside a small traced run on the CPU."""

from __future__ import annotations

import time

import pytest
import torch
from benchcore import main as harness
from benchcore import program
from benchcore import trace as tracing
from test_bench_harness import small

METRICS = sorted((harness.BENCH_DIR / "metrics").glob("*.py"))


def X(cat: str, name: str, ts: float, dur: float, **args) -> dict:
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def kernel(name: str, start: float, end: float, corr: int) -> dict:
    return X("kernel", name, start, end - start, correlation=corr)


def launch(at: float, corr: int, cat: str = "cuda_runtime") -> dict:
    return X(cat, "cudaLaunchKernel" if cat == "cuda_runtime" else "cuLaunchKernel", at, 2,
             correlation=corr)


def ocrl(name: str, start: float, end: float) -> dict:
    return X("user_annotation", "ocrl." + name, start, end - start)


def bench(name: str, start: float, end: float) -> dict:
    return X("user_annotation", "bench." + name, start, end - start)


# two pretraining steps in a window of 1000 us; the third step's kernel is
# launched through a cuda_driver record alone, the fourth through both records
PRETRAIN_HARNESS = [
    bench("window", 0, 1000), bench("update_many", 5, 805),
    kernel("sweep_fwd_kernel", 20, 50, 1), launch(15, 1),
    kernel("sm80_xmma_fprop_implicit_gemm", 60, 120, 2), launch(40, 2),
    kernel("sweep_bwd_kernel", 150, 250, 3),
    kernel("multi_tensor_apply_kernel", 320, 330, 4), launch(305, 4),
    kernel("sweep_fwd_kernel", 420, 480, 5), launch(410, 5),
    kernel("wgrad_alg0_engine", 520, 690, 6), launch(510, 6),
    kernel("multi_tensor_apply_kernel", 720, 740, 7), launch(705, 7),
    X("gpu_memcpy", "Memcpy DtoH", 810, 5, correlation=9),
    kernel("cat_kernel", 850, 860, 8), launch(820, 8),
    kernel("late_kernel", 1200, 1210, 10), launch(1190, 10)]
PRETRAIN_PROGRAM = [
    launch(120, 3, "cuda_driver"), launch(306, 4, "cuda_driver"),
    ocrl("step", 10, 400), ocrl("forward", 10, 100), ocrl("backward", 100, 300),
    ocrl("optimizer", 300, 390),
    ocrl("step", 400, 800), ocrl("forward", 400, 500), ocrl("backward", 500, 700),
    ocrl("optimizer", 700, 790)]

# two SAC vector steps: env wait, sample, upload, update with its optimizer;
# a policy call's kernel between them, outside every program span
SAC_HARNESS = [
    bench("window", 0, 1000), bench("update", 150, 400), bench("act", 430, 480),
    bench("update", 660, 900),
    kernel("sweep_fwd_kernel", 160, 300, 1), launch(155, 1),
    kernel("multi_tensor_apply_kernel", 360, 370, 2), launch(352, 2),
    kernel("sweep_fwd_kernel", 450, 470, 3), launch(440, 3),
    kernel("sweep_bwd_kernel", 700, 850, 5), launch(690, 5),
    kernel("multi_tensor_apply_kernel", 865, 875, 4)]
SAC_PROGRAM = [
    launch(861, 4, "cuda_driver"),
    ocrl("env_wait", 0, 100), ocrl("sample", 110, 120), ocrl("upload", 120, 150),
    ocrl("update", 150, 400), ocrl("optimizer", 350, 390),
    ocrl("env_wait", 500, 620), ocrl("sample", 630, 636), ocrl("upload", 636, 660),
    ocrl("update", 660, 900), ocrl("optimizer", 860, 880)]


def test_parse_links_launches_through_runtime_and_cuda_driver_records():
    got = program.parse(PRETRAIN_HARNESS + PRETRAIN_PROGRAM)
    launched = {op.start: op.launched for op in got.ops}
    assert launched[150] == 120          # a cuda_driver record alone
    assert launched[320] == 305          # the runtime record before the cuda_driver one
    assert launched[20] == 15
    assert got.window == (0, 1000)
    assert [s[0] for s in got.spans[:4]] == ["step", "forward", "backward", "optimizer"]
    assert len(got.kernels) == 8         # the late kernel started after the window
    # the harness's parse keeps no cuda_driver launch and no program range
    harness_view = tracing.parse(PRETRAIN_HARNESS + PRETRAIN_PROGRAM)
    assert {op.start: op.launched for op in harness_view.ops}[150] is None
    assert {name for name, _, _ in harness_view.spans} == {"window", "update_many"}


def test_pretraining_readings_by_hand():
    got = program.parse(PRETRAIN_HARNESS + PRETRAIN_PROGRAM)
    assert program.count(got, "step") == 2
    assert program.device_ms_under(got, {"forward"}) == pytest.approx(0.150)
    assert program.device_ms_under(got, {"backward"}) == pytest.approx(0.270)
    assert program.device_ms_under(got, {"optimizer"}) == pytest.approx(0.030)
    assert program.device_ms_under(got, {"step"}) == pytest.approx(0.450)
    assert program.device_ms_under(got, {"step", "forward"}) == pytest.approx(0.450)
    assert program.device_ms_by_span(got) == pytest.approx(
        {"backward": 0.270, "forward": 0.150, "optimizer": 0.030, "none": 0.010})
    assert program.span_ms(got, {"forward"}) == pytest.approx(0.190)
    assert program.readings(got) == pytest.approx({
        "forward_device_ms.pretrain": 0.075, "backward_device_ms.pretrain": 0.135,
        "optimizer_device_ms.pretrain": 0.015})


def test_idle_gaps_by_hand():
    """Each gap named by the innermost span among those covering most of it;
    a gap after the last step by none."""
    got = program.program_idle_gaps(program.parse(PRETRAIN_HARNESS + PRETRAIN_PROGRAM))
    assert [name for name, _ in got] == ["none", "step", "step", "step", "step", "none",
                                         "backward", "step", "forward", "forward"]
    assert [s for _, s in got] == pytest.approx([140e-6, 90e-6, 70e-6, 70e-6, 40e-6, 35e-6,
                                                 30e-6, 30e-6, 20e-6, 10e-6])


def test_sac_readings_by_hand():
    got = program.parse(SAC_HARNESS + SAC_PROGRAM)
    assert program.readings(got) == pytest.approx({
        "env_wait_ms.rl": 0.110, "sample_ms.rl": 0.035, "optimizer_device_ms.rl": 0.010})
    assert program.device_ms_under(got, {"update"}) == pytest.approx(0.310)
    assert program.device_ms_by_span(got) == pytest.approx(
        {"update": 0.290, "optimizer": 0.020, "none": 0.020})
    assert program.readings(program.parse(SAC_HARNESS)) == {}


def _record(trace, sac: bool) -> dict:
    m = {"obs_size": 64, "num_slots": 5, "slot_size": 192, "num_slot_heads": 1}
    record = {"m": m, "trace": trace, "trace_steps": 2, "window_s": 1.0,
              "bw": 3.35e12, "peak_flops": 67e12}
    if sac:
        record.update(traffic={"num_envs": 4, "batch_size": 256}, vector_steps=20,
                      env_step_ms=17.0, update_ms=150.0, update_flops=3.6e12)
    else:
        record.update(traffic={"batch_size": 64}, window_steps=100, loader_wait_ms=3.0,
                      step_flops=2.2e12)
    return record


@pytest.mark.parametrize("sac", [False, True])
def test_the_harness_reads_the_same_with_the_program_spans(sac):
    """Every reader of ``benchmark/metrics`` and ``breakdown`` give the same
    on the same events with and without the program's ranges and the
    ``cuda_driver`` launch records."""
    base = SAC_HARNESS if sac else PRETRAIN_HARNESS
    extra = SAC_PROGRAM if sac else PRETRAIN_PROGRAM
    plain, traced = tracing.parse(base), tracing.parse(base + extra)
    assert plain.breakdown() == traced.breakdown()
    cell = [p for p in METRICS if p.stem.endswith(".rl" if sac else ".pretrain")]
    assert len(cell) == (5 if sac else 6)
    for path in cell:
        reader = harness.load_module(path, "benchmetric_" + path.stem.replace(".", "_"))
        want, got = reader.read(_record(plain, sac)), reader.read(_record(traced, sac))
        assert want is not None and want == got, path.stem


@pytest.mark.parametrize("workload,root,count", [
    ("slotattention.pretrain.b64", "step", 4), ("slate.sac.b256", "update", 3)])
def test_a_small_traced_run_carries_the_program_spans(workload, root, count, monkeypatch,
                                                      tmp_path):
    seen = []
    parse = tracing.parse
    monkeypatch.setattr(tracing, "parse", lambda events: seen.append(
        program.parse(events)) or parse(events))
    result, _ = harness.run_cell(workload, 2 ** 31 + 23, 0.5, True, time.time(),
                                 device="cpu", workdir=tmp_path, **small(workload))
    assert result["correct"] is True
    got = seen[-1]
    assert program.count(got, root) == count
    inner = ["forward", "backward", "optimizer"] if root == "step" else [
        "optimizer", "sample", "upload", "env_wait"]
    assert [program.count(got, name) for name in inner] == [count] * len(inner)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,spans,share,traffic", [
    ("slotattention.pretrain.b64", ["step", "forward", "backward", "optimizer"], 0.98,
     dict(warmup_superbatches=2, trace_superbatches=1)),
    ("slate.sac.b256", ["update", "optimizer", "upload"], 0.9,
     dict(batch_size=64, learning_starts=200, trace_steps=4))])
def test_the_kernels_fall_under_the_program_spans_on_the_card(workload, spans, share, traffic,
                                                              monkeypatch, tmp_path):
    """A short traced run at the cell's widths: every kernel linked to its
    launch and launched under the cell's spans or none (SAC's policy call),
    the root span's share of the kernel time at least ``share`` (SAC's update
    at a quarter of its batch leaves the policy call at 4 rows a few per
    cent), and a pretraining step's phases adding up to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seen = []
    parse = tracing.parse
    monkeypatch.setattr(tracing, "parse", lambda events: seen.append(
        program.parse(events)) or parse(events))
    result, _ = harness.run_cell(workload, 2 ** 31 + 29, 1.0, True, time.time(),
                                 workdir=tmp_path, traffic_overrides=traffic)
    assert result["correct"] is True
    got = seen[-1]
    by_span = program.device_ms_by_span(got)
    total = sum(by_span.values())
    assert set(by_span) <= set(spans) | {"none"}
    root = spans[0]
    assert program.device_ms_under(got, {root}) >= share * total
    if root == "step":
        phases = sum(program.device_ms_under(got, {p}) for p in spans[1:])
        assert phases == pytest.approx(total, rel=0.02)
