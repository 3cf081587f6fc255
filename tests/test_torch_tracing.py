"""The port's spans on a torch.profiler trace (``ocrl_tpu_torch.utils.tracing``),
on the CPU at small widths: off without a profiler, nested as documented
under one, in the OCR step, in SAC's vector step and in ``train_ocr``'s
``profile_dir`` trace; and ``train_ocr``'s printed rate leaves evaluation out."""

from __future__ import annotations

import json
import re
import types

import numpy as np
import pytest
import torch

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch import train_ocr
from ocrl_tpu_torch.config import read_env_config
from ocrl_tpu_torch.data.collect import collect_dataset
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.envs.spaces import Box
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.rl import SAC, VecEnv, build_sac_policy
from ocrl_tpu_torch.utils import tracing

SMALL = [("env.obs_size", 16), ("ocr.use_bcdec", True), ("ocr.cnn.hidden_size", 16),
         ("ocr.slotattr.num_slots", 3), ("ocr.slotattr.slot_size", 32),
         ("ocr.slotattr.mlp_hidden_size", 32), ("ocr.dvae.vocab_size", 32),
         ("ocr.dvae.d_model", 32), ("ocr.tfdec.num_dec_blocks", 2),
         ("ocr.tfdec.num_dec_heads", 2), ("ocr.learning.dropout", 0.0)]
B, K = 2, 2
STEP_PHASES = ["forward", "backward", "optimizer"]
GT_SAC = ["ocr=gt", "sb3=sac", "sb3_acnet=mlp", "env=cw-target-N4C4S1S1",
          "env.use_fake_sim=true", "pooling=mlp", "env.render_mode=state"]


def small_ocr(seed: int = 0):
    cfg = tcfg.PolicyConfig()
    for path, value in SMALL:
        cfg = tcfg.replace(cfg, path, value)
    return create_ocr(cfg.ocr, cfg.env, seed, "cpu")


def superbatch() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (K * B, 16, 16, 3), dtype=np.uint8)


def profiled(fn, tmp_path):
    """(fn's result, the ``ocrl.*`` ranges of its exported CPU trace as (name
    without the prefix, start, end), in order of start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    return out, program_ranges(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])


def program_ranges(events: list[dict]) -> list[tuple[str, float, float]]:
    got = [(e["name"][len(tracing.PREFIX):], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("name", "").startswith(tracing.PREFIX)]
    return sorted(got, key=lambda r: (r[1], -r[2]))


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_enters_no_record_function(monkeypatch, tmp_path):
    """No profiler: every span is the one shared null context, and the
    steps' numbers are those of the same steps under a profiler."""
    entered = []

    class Counted(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    assert tracing.span("step") is tracing.span("forward")
    obs = superbatch()
    plain = small_ocr().update_many(obs, None, 0, K)
    assert entered == []
    traced, ranges = profiled(lambda: small_ocr().update_many(obs, None, 0, K), tmp_path)
    assert entered.count("ocrl.step") == K and len(ranges) == 4 * K
    assert plain.keys() == traced.keys()
    for key in plain:
        assert torch.equal(plain[key], traced[key]), key


def test_update_many_nests_its_phases_in_each_step(tmp_path):
    _, ranges = profiled(lambda: small_ocr().update_many(superbatch(), None, 0, K), tmp_path)
    steps = [r for r in ranges if r[0] == "step"]
    assert len(steps) == K
    for step in steps:
        phases = [r for r in ranges if r[0] != "step" and inside(r, step)]
        assert [r[0] for r in phases] == STEP_PHASES
        assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_sac_learn_marks_its_vector_step(tmp_path):
    """GT on the CausalWorld states, 2 envs in this process: 5 vector steps,
    the last 4 each followed by an update."""
    conf = tcfg.compose(tcfg.TrainSB3Config(), GT_SAC)
    policy = build_sac_policy(conf, Box(-1.0, 1.0, (3,), np.float32), seed=1, device="cpu")[0]
    env_cfg = tcfg.replace(conf.env, "use_fake_sim", True)
    vec_env = VecEnv([lambda s=s: make_env(env_cfg, s) for s in (3, 4)])
    sac = SAC(policy, vec_env.observation_space.shape, False, 2,
              tcfg.SACConfig(batch_size=4, ent_coef="auto_0.1", learning_starts=4,
                             buffer_size=20), seed=0, device="cpu")
    _, ranges = profiled(lambda: sac.learn(vec_env, 10), tmp_path)
    names = [r[0] for r in ranges]
    assert names.count("env_wait") == 5
    assert names.count("update") == names.count("sample") == names.count("upload") == 4
    updates = [r for r in ranges if r[0] == "update"]
    for opt in (r for r in ranges if r[0] == "optimizer"):
        assert sum(inside(opt, u) for u in updates) == 1
    assert names.count("optimizer") == 4
    for r in ranges:
        if r[0] in ("env_wait", "sample", "upload"):
            assert not any(inside(r, u) for u in updates), r


def test_profile_dir_trace_carries_the_spans_and_the_rate_leaves_evaluation_out(
        tmp_path, monkeypatch, capsys):
    """``train_ocr.main`` at batch 2 in superbatches of 4 over 20 steps, an
    evaluation every 6 steps, on a clock that moves 1 s a reading and 1000 s
    an evaluation: the trace of steps 12-19 holds 8 ``ocrl.step`` ranges and
    their phases, and no printed rate counts an evaluation's seconds."""
    collect_dataset(tcfg.replace(read_env_config("random-N5C4S4S2"), "obs_size", 16), 16, 2,
                    out_file=tmp_path / "ds.hdf5")
    clock = [0.0]

    def now():
        clock[0] += 1.0
        return clock[0]

    evaluate = train_ocr.eval_and_save

    def slow_eval(*args, **kwargs):
        clock[0] += 1000.0
        return evaluate(*args, **kwargs)

    monkeypatch.setattr(train_ocr, "time", types.SimpleNamespace(
        time=now, strftime=train_ocr.time.strftime))
    monkeypatch.setattr(train_ocr, "eval_and_save", slow_eval)
    over = [f"{'dataset' if k.startswith('env.') else 'ocr'}.{k.split('.', 1)[1]}={v}"
            for k, v in SMALL]
    result = train_ocr.main(["ocr=slate", "dataset=random-N5C4S4S2",
                             f"dataset.datadir={tmp_path}/ds.hdf5", "batch_size=2",
                             "superbatch=4", "eval_interval=6", "log_interval=4",
                             "max_steps=20", f"run_dir={tmp_path}/run",
                             f"profile_dir={tmp_path}/trace"] + over, device="cpu")
    assert result["step"] == 20
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = ["ocrl." + r[0] for r in program_ranges(events)]
    assert names.count("ocrl.step") == 8
    assert all(names.count("ocrl." + phase) == 8 for phase in STEP_PHASES)
    rates = [float(r) for r in re.findall(r"\(([0-9.]+) imgs/s\)", capsys.readouterr().out)]
    assert len(rates) >= 5
    assert min(rates) > 8 / 10, rates      # a superbatch's 8 images over a few readings


@pytest.mark.parametrize("recording", [False, True])
def test_span_is_a_record_function_exactly_while_a_profiler_records(recording):
    if not recording:
        assert not isinstance(tracing.span("step"), torch.profiler.record_function)
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tracing.span("step")
        assert isinstance(got, torch.profiler.record_function)
        assert got.name == "ocrl.step"
