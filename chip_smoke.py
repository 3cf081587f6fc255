#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py             # from the root of a checkout
    python3 chip_smoke.py --profile   # also print a device-time breakdown

Phases, each printing its own line with its seconds:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port, with nvcc, in parallel; each
   kernel's registers and spill bytes from ptxas -v (a spill fails the run);
3. kernels: each kernel against its plain torch version on the card, at the
   shapes of the serving and the training paths plus other supported ones,
   with its device time (torch.profiler; CUDA events where a profiler
   session twice records no kernel), the plain version's and the card's
   bound for the same work; B3 and B4 launched twice on the same inputs
   must give bitwise-equal outputs; the Gumbel kernels' drawn fields against
   the Gumbel distribution, B2's id frequencies against the softmax, and
   B2 on rows with NaN against its plain version (the first NaN's index);
4. serving: the full-width slate-transformer policy (seed 0) answers
   PPO.predict requests at 16 and at 64 observations; the launch counts are
   reset just before and read just after, and two requests are checked
   against the same policy with every kernel replaced by its plain version;
5. training: the full-width SLATE OCR (seed 0) takes pretraining steps on
   uint8 batches of 24 through OCR.update_many, timed, with the launch
   counts reset just before and read just after; one step is checked
   against the same model with every kernel replaced by its plain version,
   fed the Gumbel fields the kernels drew; and the loss on one fixed batch
   falls.

Then one JSON line of the kernels and, last, the contract line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
ocrl_tpu_torch package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from ocrl_tpu_torch.config import EnvConfig, OCRConfig, PolicyConfig
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models.slate import GROUP_OF
from ocrl_tpu_torch.ops import LAUNCHES, build, gumbel, reset_launches, slot_routing
from ocrl_tpu_torch.ops._build import build_log, ptxas_usage, sources
from ocrl_tpu_torch.rl import PPO, build_policy

# kernel vs plain, per output: max |kernel - plain| <= SWEEP_TOL * max |plain|.
# Both are fp32; the sums over D and over the tokens run in another order,
# so the error scales with the magnitude of what is summed, not of each entry.
SWEEP_TOL = 1e-5
POLICY_TOL = dict(rtol=1e-4, atol=1e-4)  # whole policy: the recurrence carries them on
# B1: y in [0, 1] from expf and a reordered row sum against torch's exp and
# sum, a few ulps. B2: the same fp32 sums logits + g on both sides, so the
# ids agree exactly.
SOFT_TOL = 1e-5
# A drawn Gumbel field of n values: its mean (Euler's gamma) and variance
# (pi^2 / 6) within 8 standard errors, 1.2825 / sqrt(n) for the mean and
# 3.45 / sqrt(n) for the variance (excess kurtosis 2.4): at the training
# shape's 25.2 M draws, 2.0e-3 and 5.5e-3.
GUMBEL_MEAN, GUMBEL_VAR = 0.5772156649015329, float(np.pi ** 2 / 6)
GUMBEL_SIGMAS = 8.0
FREQ_TOL = 0.01      # id frequencies over 65536 draws, 4-5 standard errors
# One training step, kernels against plain versions fed the same fields and
# dropout masks: the loss to 1e-5 relative; each gradient to 1e-3 of its
# own largest entry plus 1e-6 of the model's largest (fp32 sums reordered
# through the 3-iteration recurrence and cuDNN's backward algorithms); the
# parameters' change over the group's lr to 1e-2 where the plain gradient
# exceeds 1e-6, i.e. 100 x Adam's eps (below that, Adam's first step
# g / (|g| + eps) turns rounding of the gradient into any value in [-1, 1]).
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_GRAD_FLOOR, STEP_MOVE_TOL = 1e-5, 1e-3, 1e-6, 1e-2
REQUESTS = 20
BATCHES = (16, 64)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_K = 24, 4, 20, 4

# Published rates (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and fp32 FLOP/s outside the tensor cores.
CARD_RATES = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def card_rates(name: str) -> tuple[str, float, float]:
    for key, (bw, flops) in CARD_RATES.items():   # most specific names first
        if all(word in name for word in key.split()):
            return key, bw, flops
    raise SystemExit(f"no published rates for '{name}' in CARD_RATES")


def wall_ms(fn, reps: int = 50) -> float:
    """Time per call between CUDA events around many calls: device time,
    or the host's when it cannot keep the device fed."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps: int):
    """(wall seconds, torch.profiler key averages) over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def device_ms(averages, name_part: str = "") -> float | None:
    """Summed device time (ms) of the CUDA kernels whose name holds
    ``name_part``, or None where the profiler recorded none of them."""
    from torch.autograd import DeviceType

    us = sum(e.self_device_time_total for e in averages
             if e.device_type == DeviceType.CUDA and name_part in e.key
             and not getattr(e, "is_user_annotation", False))  # e.g. Optimizer.step
    return us / 1e3 if us > 0 else None


def per_call_ms(fn, *name_parts: str, reps: int = 20) -> tuple[float, ...]:
    """Device ms per call of ``fn``, summed over the CUDA kernels whose name
    holds each of ``name_parts`` ("" for all of them), by torch.profiler.
    CUPTI now and then hands a profiler session no kernel records at all;
    then the session is taken once more, and if that misses too, each
    number is the span between CUDA events around ``reps`` calls, which
    holds every kernel of the call and the gaps between them."""
    name_parts = name_parts or ("",)
    for _ in range(2):
        _, averages = profiled(fn, reps)
        got = [device_ms(averages, part) for part in name_parts]
        if all(ms is not None for ms in got):
            return tuple(ms / reps for ms in got)
    print(f"    (the profiler saw no device time for {name_parts} twice: "
          f"CUDA events instead)", flush=True)
    return (wall_ms(fn, reps),) * len(name_parts)


def sweep_bytes(B: int, N: int, S: int, D: int) -> int:
    """Bytes route_sweep must move: read k, v, q once, write a, S_a, A_v once."""
    return 4 * (2 * B * N * D + B * S * D + B * N * S + B * S + B * S * D)


def sweep_bound_ms(B: int, N: int, S: int, D: int, bw: float, flops: float):
    """Least time for route_sweep: its bytes; two [N, S, D] products and the
    softmax over S per token."""
    ops = 4 * B * N * S * D + 4 * B * N * S
    t_bytes, t_ops = sweep_bytes(B, N, S, D) / bw, ops / flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_repeatable(name: str, fn, first) -> None:
    """A second launch on the same inputs gives bitwise the same outputs."""
    again = fn()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, again))
    print(f"    {name}: second launch bitwise equal: {'yes' if same else 'NO'}", flush=True)
    if not same:
        raise SystemExit(f"{name} is not deterministic")


def check_sweep(shape, bw, flops, gen):
    B, N, S, D = shape
    k = torch.randn(B, N, D, device="cuda", generator=gen) * D ** -0.5
    v = torch.randn(B, N, D, device="cuda", generator=gen)
    q = torch.randn(B, S, D, device="cuda", generator=gen)
    got = slot_routing.route_sweep(k, v, q)
    want = slot_routing.route_sweep_reference(k, v, q)
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scales = [w.abs().max().item() for w in want]
    ok = all(e <= SWEEP_TOL * s for e, s in zip(errs, scales))
    rel = ", ".join(f"{name} {e:.2e}/{s:.2e}" for name, e, s
                    in zip(("S_a", "A_v", "a"), errs, scales))
    print(f"  route_sweep B={B} N={N} S={S} D={D}: max_abs_err/max_abs ({rel}), "
          f"tolerance {SWEEP_TOL} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit(f"route_sweep disagrees with its plain version at {shape}")
    check_repeatable("route_sweep", lambda: slot_routing.route_sweep(k, v, q), got)
    ms, kernel_alone_ms = per_call_ms(     # the sweep with its row sums, and alone
        lambda: slot_routing.route_sweep(k, v, q), "", "sweep_fwd_kernel")
    plain_ms, = per_call_ms(lambda: slot_routing.route_sweep_reference(k, v, q))
    call_ms = wall_ms(lambda: slot_routing.route_sweep(k, v, q))
    bound_ms, bound_by = sweep_bound_ms(B, N, S, D, bw, flops)
    print(f"    device ms: route_sweep {ms:.4f} (sweep kernel alone {kernel_alone_ms:.4f}), "
          f"plain {plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}), "
          f"{100 * bound_ms / ms:.1f} % of it, {sweep_bytes(B, N, S, D) / ms / 1e9:.3f} TB/s; "
          f"wall per call {call_ms:.4f} ms", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def gumbel_bound_ms(R: int, V: int, soft: bool, bw: float, flops: float):
    """Least time for one Gumbel kernel: read the logits and the seed once,
    write y [R, V] (soft) or the ids [R]; per value about 10 fp32
    operations (the uniform, two logs, the add and for the soft sample the
    divide, max, exp, sum and normalise), the Philox integer work aside."""
    nbytes = 4 * R * V + 8 + (4 * R * V if soft else 4 * R)
    ops = (10 if soft else 5) * R * V
    t_bytes, t_ops = nbytes / bw, ops / flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_bwd_bytes(B: int, N: int, S: int, D: int) -> int:
    """Bytes the sweep's backward must move: read k, v, a, g_a, q, g_av once,
    write gk, gv, gq once."""
    return 4 * (4 * B * N * D + 2 * B * N * S + 3 * B * S * D)


def sweep_bwd_bound_ms(B: int, N: int, S: int, D: int, bw: float, flops: float):
    """Least time for the sweep's backward: its bytes; per token 8 S D
    operations (v . g_av, dl q, a g_av and the dl^T k partial)."""
    ops = 8 * B * N * S * D + 6 * B * N * S
    t_bytes, t_ops = sweep_bwd_bytes(B, N, S, D) / bw, ops / flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed(kernel_fn, plain_fn, kernel_name: str = ""):
    """Device ms per call of the kernel's wrapper, of the kernel alone (the
    kernels whose name holds ``kernel_name``) and of the plain version, and
    the wrapper's wall ms per call (CUDA events)."""
    ms, kernel_alone_ms = per_call_ms(kernel_fn, "", kernel_name)
    plain_ms, = per_call_ms(plain_fn)
    return ms, kernel_alone_ms, plain_ms, wall_ms(kernel_fn)


def check_gumbel(R, V, bw, flops, gen, time_it=True):
    """B1 and B2 at [R, V] against their plain versions fed the fields the
    kernels drew (g_out); the fields against the Gumbel distribution."""
    mean_tol = GUMBEL_SIGMAS * 1.2825 / np.sqrt(R * V)
    var_tol = GUMBEL_SIGMAS * 3.45 / np.sqrt(R * V)
    logits = torch.randn(R, V, device="cuda", generator=gen) * 3
    tau = 0.55
    results = {}
    for soft in (True, False):
        g = torch.empty_like(logits)
        if soft:
            got = gumbel.gumbel_softmax_sample(logits, tau, generator=gen, g_out=g)
            want = gumbel.gumbel_softmax_sample_reference(logits, g, tau)
            err = (got - want).abs().max().item()
            ok = err <= SOFT_TOL
        else:
            got = gumbel.gumbel_argmax_ids(logits, generator=gen, g_out=g)
            want = gumbel.gumbel_argmax_ids_reference(logits, g)
            err = float((got != want).sum().item())
            ok = err == 0
        g64 = g.double()
        mean, var = g64.mean().item(), g64.var().item()
        dist_ok = abs(mean - GUMBEL_MEAN) <= mean_tol and abs(var - GUMBEL_VAR) <= var_tol
        name = gumbel.SOFT_KERNEL if soft else gumbel.IDS_KERNEL
        what = f"max_abs_err {err:.3e} (tolerance {SOFT_TOL})" if soft else \
            f"{int(err)} ids differ (tolerance 0)"
        print(f"  {name} R={R} V={V}: {what} {'ok' if ok else 'MISMATCH'}; field mean "
              f"{mean:.5f} (gamma {GUMBEL_MEAN:.5f} +- {mean_tol:.1e}), var {var:.5f} "
              f"(pi^2/6 {GUMBEL_VAR:.5f} +- {var_tol:.1e}) {'ok' if dist_ok else 'OFF'}",
              flush=True)
        if not (ok and dist_ok):
            raise SystemExit(f"{name} disagrees with its plain version or the "
                             f"Gumbel distribution at {(R, V)}")
        if not time_it:
            continue
        if soft:
            kernel_fn = lambda: gumbel.gumbel_softmax_sample(logits, tau, generator=gen)
            plain_fn = lambda: gumbel.gumbel_softmax_sample_reference(
                logits, gumbel.gumbel_field(logits.shape, gen, logits.device), tau)
        else:
            kernel_fn = lambda: gumbel.gumbel_argmax_ids(logits, generator=gen)
            plain_fn = lambda: gumbel.gumbel_argmax_ids_reference(
                logits, gumbel.gumbel_field(logits.shape, gen, logits.device))
        ms, _, plain_ms, call_ms = timed(kernel_fn, plain_fn)
        bound_ms, bound_by = gumbel_bound_ms(R, V, soft, bw, flops)
        note = ""
        if soft:   # a yardstick only: softmax of an already noised copy
            noised = (logits + g) / tau
            note = f"; torch.softmax of a pre-noised copy " \
                f"{per_call_ms(lambda: torch.softmax(noised, -1))[0]:.4f}"
        print(f"    device ms: {name} {ms:.4f}, plain (torch field + "
              f"{'softmax' if soft else 'argmax'}) {plain_ms:.4f}, bound {bound_ms:.4f} "
              f"({bound_by}){note}; wall per call {call_ms:.4f} ms", flush=True)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    return results


def check_id_frequencies(gen):
    """One row repeated: B2's id frequencies ~ softmax(row) (as
    tests/test_ops.py holds the JAX version)."""
    row = torch.full((1, 128), -1e9, device="cuda")
    row[0, :4] = torch.tensor([2.0, 1.0, 0.0, -1.0], device="cuda")
    ids = gumbel.gumbel_argmax_ids(row.repeat(65536, 1), generator=gen)
    freq = (torch.bincount(ids, minlength=4)[:4].double() / 65536).cpu()
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.0, -1.0], dtype=torch.float64), 0)
    err = (freq - want).abs().max().item()
    print(f"  gumbel_ids frequencies {[round(f, 4) for f in freq.tolist()]} vs softmax "
          f"{[round(f, 4) for f in want.tolist()]}: max diff {err:.4f} (tolerance "
          f"{FREQ_TOL}) {'ok' if err <= FREQ_TOL else 'OFF'}", flush=True)
    if err > FREQ_TOL:
        raise SystemExit("gumbel_ids frequencies disagree with the softmax")


def check_ids_nan(R: int, V: int, gen) -> None:
    """B2 on rows that hold NaN, given a zero field: the plain version's ids
    (the first NaN's index, as jnp.argmax), every id below V."""
    logits = torch.randn(R, V, device="cuda", generator=gen)
    cols = torch.randint(0, V, (R // 2, 3), device="cuda", generator=gen)
    logits[torch.arange(R // 2, device="cuda")[:, None], cols] = float("nan")
    logits[R // 2:R // 2 + 4] = float("nan")     # whole rows of NaN
    logits[R - 1] = -float("inf")                # a row of -inf: id 0
    zeros = torch.zeros_like(logits)
    got = gumbel.gumbel_argmax_ids(logits, noise=zeros)
    want = gumbel.gumbel_argmax_ids_reference(logits, zeros)
    differ = int((got != want).sum().item())
    top = int(got.max().item())
    ok = differ == 0 and top < V
    print(f"  gumbel_ids R={R} V={V} with NaN rows: {differ} ids differ from the plain "
          f"version (tolerance 0), largest id {top} (< {V}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise SystemExit("gumbel_ids mishandles NaN")


def report_ptxas(names: list[str]) -> None:
    """Registers and spill bytes of every kernel of the named sources, from
    the ptxas report kept beside each library (built now or earlier); a
    spill anywhere, or a library without its report, fails the run."""
    spilled = []
    for name in names:
        families: dict[str, list[str]] = {}
        for kernel, use in ptxas_usage(build_log(name)).items():
            family, _, arg = kernel.partition("<")
            families.setdefault(family, []).append(
                f"{arg.rstrip('>') or '-'}:{use['registers']}r/"
                f"{use['spill_stores'] + use['spill_loads']}B")
            if use["spill_stores"] or use["spill_loads"]:
                spilled.append(kernel)
        if not families:
            raise SystemExit(f"the ptxas report of {name}.cu names no kernel")
        for family, entries in families.items():
            print(f"  ptxas {name}.cu {family} (template argument: registers/spill "
                  f"bytes): {' '.join(entries)}", flush=True)
    if spilled:
        raise SystemExit(f"register spills in {spilled}")


def check_sweep_bwd(shape, bw, flops, gen):
    """B4 against autograd of the plain sweep, given the same cotangents."""
    B, N, S, D = shape
    k = torch.randn(B, N, D, device="cuda", generator=gen) * D ** -0.5
    v = torch.randn(B, N, D, device="cuda", generator=gen)
    q = torch.randn(B, S, D, device="cuda", generator=gen)
    g_sa = torch.randn(B, S, device="cuda", generator=gen)
    g_av = torch.randn(B, S, D, device="cuda", generator=gen)
    g_a = torch.randn(B, N, S, device="cuda", generator=gen)
    _, _, a = slot_routing.route_sweep(k, v, q)
    kernel_fn = lambda: slot_routing._sweep_bwd(  # noqa: E731 - the Function's backward
        k, v, q, a, g_av, (g_a + g_sa[:, None, :]).contiguous())
    got = kernel_fn()
    leaves = [x.clone().requires_grad_() for x in (k, v, q)]
    outs = slot_routing.route_sweep_reference(*leaves)
    plain_fn = lambda: torch.autograd.grad(outs, leaves, (g_sa, g_av, g_a),  # noqa: E731
                                           retain_graph=True)
    want = plain_fn()
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scales = [w.abs().max().item() for w in want]
    ok = all(e <= SWEEP_TOL * s for e, s in zip(errs, scales))
    rel = ", ".join(f"{name} {e:.2e}/{s:.2e}" for name, e, s
                    in zip(("gk", "gv", "gq"), errs, scales))
    print(f"  route_sweep backward B={B} N={N} S={S} D={D}: max_abs_err/max_abs ({rel}), "
          f"tolerance {SWEEP_TOL} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit(f"the sweep's backward disagrees with its plain version at {shape}")
    check_repeatable("route_sweep backward", kernel_fn, got)
    ms, kernel_alone_ms, plain_ms, call_ms = timed(kernel_fn, plain_fn, "sweep_bwd_kernel")
    bound_ms, bound_by = sweep_bwd_bound_ms(B, N, S, D, bw, flops)
    print(f"    device ms: backward {ms:.4f} (sweep kernel alone {kernel_alone_ms:.4f}), plain "
          f"(autograd) {plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}), "
          f"{100 * bound_ms / ms:.1f} % of it, {sweep_bwd_bytes(B, N, S, D) / ms / 1e9:.3f} "
          f"TB/s; wall per call {call_ms:.4f} ms", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


@contextmanager
def plain_sweep():
    """The policy with the routing kernel replaced by its plain version."""
    kernel = slot_routing.route_sweep
    slot_routing.route_sweep = slot_routing.route_sweep_reference
    try:
        yield
    finally:
        slot_routing.route_sweep = kernel


def check_request(algo: PPO, obs: np.ndarray, num_slots: int, slot_size: int):
    gen = torch.Generator(device="cuda").manual_seed(obs.shape[0])
    noise = torch.randn(obs.shape[0], num_slots, slot_size, device="cuda",
                        generator=gen)
    actions, logits, values = algo.act_deterministic(obs, noise=noise)
    with plain_sweep():
        want_actions, want_logits, want_values = algo.act_deterministic(obs, noise=noise)
    torch.cuda.synchronize()
    E = obs.shape[0]
    if logits.shape != (E, 4) or values.shape != (E,):
        raise SystemExit(f"policy outputs {tuple(logits.shape)}, {tuple(values.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(values).all()):
        raise SystemExit("policy outputs are not finite")
    err = max((logits - want_logits).abs().max().item(),
              (values - want_values).abs().max().item())
    same = bool((actions == want_actions).all())
    ok = same and torch.allclose(logits, want_logits, **POLICY_TOL) \
        and torch.allclose(values, want_values, **POLICY_TOL)
    print(f"  check E={E}: actions {'equal' if same else 'DIFFER'}, logits/values "
          f"max_abs_err {err:.3e} (rtol {POLICY_TOL['rtol']}, atol "
          f"{POLICY_TOL['atol']}) against the plain sweep", flush=True)
    if not ok:
        raise SystemExit(f"serving path disagrees with its plain version at E={E}")


def serve(algo: PPO, requests: list[np.ndarray]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for obs in requests:
        actions = algo.predict(obs)      # returns numpy: waits for the card
        if actions.shape != (obs.shape[0],) or not np.isin(actions, range(4)).all():
            raise SystemExit(f"bad actions {actions!r}")
    return time.perf_counter() - t0


def profile(label: str, fn, reps: int, rows: int) -> None:
    """Device time by kernel and the device's busy share over ``reps`` calls."""
    wall, averages = profiled(fn, reps)
    busy = device_ms(averages)
    print(averages.table(sort_by="self_device_time_total", row_limit=rows), flush=True)
    share = "not measured (the profiler saw no device time)" if busy is None else \
        f"{busy:.3f} ms ({100 * busy / (1e3 * wall):.1f} %)"
    print(f"  {label} in {1e3 * wall:.3f} ms under the profiler; device busy {share}",
          flush=True)


@contextmanager
def plain_kernels(fields: dict):
    """The OCR with every kernel replaced by its plain version: the routing
    sweep by autograd of the plain sweep, the Gumbel kernels by their plain
    versions fed ``fields`` (those the kernels drew). Each still draws the
    seed its kernel would, so that the generator, and with it the slot noise
    and the dropout masks, stays in step with the kernel run."""
    saved = (slot_routing.route_sweep, gumbel.gumbel_softmax_sample,
             gumbel.gumbel_argmax_ids)

    def soft(logits, tau, *, generator=None, noise=None, g_out=None):
        gumbel.draw_seed(generator, logits.device)
        return gumbel.gumbel_softmax_sample_reference(logits, fields["soft"], tau)

    def ids(logits, *, generator=None, noise=None, g_out=None):
        gumbel.draw_seed(generator, logits.device)
        return gumbel.gumbel_argmax_ids_reference(logits.detach(), fields["ids"])

    slot_routing.route_sweep = slot_routing.route_sweep_reference
    gumbel.gumbel_softmax_sample, gumbel.gumbel_argmax_ids = soft, ids
    try:
        yield
    finally:
        (slot_routing.route_sweep, gumbel.gumbel_softmax_sample,
         gumbel.gumbel_argmax_ids) = saved


def check_step(ocr_cfg, env_cfg, obs: np.ndarray):
    """One update of a fresh model through the kernels against the same
    update through the plain versions, from identical params and generator
    state, the plain side fed the Gumbel fields the kernels drew."""
    kernel_ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
    plain_ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
    start = {k: v.clone() for k, v in kernel_ocr.module.state_dict().items()}
    drawn = {}
    got = kernel_ocr.update(obs, None, 0, noise=drawn)
    fields = {k: drawn[k] for k in ("soft", "ids")}
    plain_drawn = dict(fields)
    with plain_kernels(fields):
        want = plain_ocr.update(obs, None, 0, noise=plain_drawn)
    torch.cuda.synchronize()
    if not torch.equal(plain_drawn["slots"], drawn["slots"]):
        raise SystemExit("the plain run drew other slot noise: generators out of step")
    loss, want_loss = got["loss"].item(), want["loss"].item()
    loss_ok = abs(loss - want_loss) <= STEP_LOSS_RTOL * abs(want_loss) and np.isfinite(loss)
    grads = dict(kernel_ocr.module.named_parameters())
    plain_grads = dict(plain_ocr.module.named_parameters())
    top = max(p.grad.abs().max().item() for p in plain_grads.values())
    worst_grad, grad_ok = 0.0, True
    for name, p in plain_grads.items():
        err = (grads[name].grad - p.grad).abs().max().item()
        limit = STEP_GRAD_TOL * p.grad.abs().max().item() + STEP_GRAD_FLOOR * top
        worst_grad = max(worst_grad, err / max(limit, 1e-30))
        grad_ok &= err <= limit
    lrs = {g["group"]: g["lr"] for g in plain_ocr.optimizer.adam.param_groups}
    after, plain_after = kernel_ocr.module.state_dict(), plain_ocr.module.state_dict()
    worst_move, compared, total = 0.0, 0, 0
    for name, p in plain_grads.items():
        lr = lrs[GROUP_OF[name.split(".")[0]]]
        sure = p.grad.abs() > 1e-6
        moved = ((after[name] - start[name]) - (plain_after[name] - start[name])) / lr
        if sure.any():
            worst_move = max(worst_move, moved[sure].abs().max().item())
        compared += int(sure.sum())
        total += p.numel()
    move_ok = worst_move <= STEP_MOVE_TOL
    print(f"  step check against the plain versions: loss {loss:.6f} vs {want_loss:.6f} "
          f"(rtol {STEP_LOSS_RTOL}); gradients worst {worst_grad:.3f} of their tolerance "
          f"({STEP_GRAD_TOL} of each leaf's max + {STEP_GRAD_FLOOR} of the model's "
          f"{top:.3e}); parameter change over lr worst {worst_move:.3e} (tolerance "
          f"{STEP_MOVE_TOL}) on {compared} of {total} entries with |g| > 1e-6",
          flush=True)
    if not (loss_ok and grad_ok and move_ok):
        raise SystemExit("the training step disagrees with its plain version")


def train_steps(ocr, batches: list[np.ndarray], step0: int) -> tuple[float, dict]:
    """update_many in superbatches of TRAIN_K; (seconds, stacked metrics)."""
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(batches), TRAIN_K):
        metrics.append(ocr.update_many(np.concatenate(batches[i:i + TRAIN_K]), None,
                                       step0 + i, TRAIN_K))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, {k: torch.cat([m[k].cpu() for m in metrics]) for k in metrics[0]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    with phase("device"):
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        kind = torch.cuda.get_device_name(0)
        rates_key, bw, flops = card_rates(kind)
        print(f"  {kind}, {torch.cuda.device_count()} device(s); torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}; rates of "
              f"{rates_key}: {bw / 1e12} TB/s, {flops / 1e12} TFLOP/s fp32",
              flush=True)

    with phase("build"):
        for name, seconds in build().items():
            print(f"  nvcc {name}.cu: {seconds:.2f} s", flush=True)
        report_ptxas(sources())

    cfg = PolicyConfig()
    sa = cfg.ocr.slotattr
    serving_shape = (BATCHES[0], cfg.env.obs_size ** 2, sa.num_slots, sa.slot_size)
    ocr_cfg, env_cfg = OCRConfig(), EnvConfig()
    train_shape = (TRAIN_BATCH,) + serving_shape[1:]
    tokens = TRAIN_BATCH * (env_cfg.obs_size // 4) ** 2
    with phase("kernels"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        sweep = check_sweep(serving_shape, bw, flops, gen)
        for shape in [train_shape, (BATCHES[1],) + serving_shape[1:], (2, 4096, 6, 192),
                      (3, 333, 5, 192), (2, 100, 16, 64)]:
            check_sweep(shape, bw, flops, gen)
        sweep_bwd = check_sweep_bwd(train_shape, bw, flops, gen)
        for shape in [serving_shape, (BATCHES[1],) + serving_shape[1:], (2, 4096, 6, 192),
                      (3, 333, 5, 192), (2, 100, 16, 64)]:
            check_sweep_bwd(shape, bw, flops, gen)
        soft_ids = check_gumbel(tokens, ocr_cfg.dvae.vocab_size, bw, flops, gen)
        check_gumbel(1000, 512, bw, flops, gen, time_it=False)
        check_id_frequencies(gen)
        check_ids_nan(tokens, ocr_cfg.dvae.vocab_size, gen)
        check_ids_nan(1000, 512, gen)

    with phase("serving"):
        policy = build_policy(cfg, seed=0)
        algo = PPO(policy, (cfg.env.obs_size, cfg.env.obs_size, 3), seed=0)
        rng = np.random.default_rng(0)
        shape = (cfg.env.obs_size, cfg.env.obs_size, cfg.env.obs_channels)
        requests = {E: [rng.integers(0, 256, (E,) + shape, dtype=np.uint8)
                        for _ in range(REQUESTS)] for E in BATCHES}
        for E in BATCHES:                     # warm-up, outside the count
            serve(algo, requests[E][:2])
        reset_launches()
        seconds = {E: serve(algo, requests[E]) for E in BATCHES}
        launches = dict(LAUNCHES)
        expected = sa.num_iterations * REQUESTS * len(BATCHES)
        for E in BATCHES:
            print(f"  E={E}: {1e3 * seconds[E] / REQUESTS:.3f} ms/request, "
                  f"{E * REQUESTS / seconds[E]:.1f} obs/s", flush=True)
        print(f"  launches {launches}, expected {slot_routing.KERNEL}: {expected}",
              flush=True)
        if launches != {slot_routing.KERNEL: expected}:
            raise SystemExit("the serving path did not launch each kernel as expected")
        for E in BATCHES:
            check_request(algo, requests[E][0], sa.num_slots, sa.slot_size)

    with phase("training"):
        rng = np.random.default_rng(0)
        shape = (TRAIN_BATCH, env_cfg.obs_size, env_cfg.obs_size, env_cfg.obs_channels)
        batch = rng.integers(0, 256, shape, dtype=np.uint8)
        check_step(ocr_cfg, env_cfg, batch)
        ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
        start = {k: v.clone() for k, v in ocr.module.state_dict().items()}
        _, warm = train_steps(ocr, [batch] * TRAIN_WARMUP, 0)   # outside the count
        reset_launches()
        train_seconds, timed_metrics = train_steps(ocr, [batch] * TRAIN_STEPS, TRAIN_WARMUP)
        train_launches = dict(LAUNCHES)
        per_step = {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1,
                    slot_routing.KERNEL: sa.num_iterations,
                    slot_routing.BWD_KERNEL: sa.num_iterations}
        train_expected = {k: n * TRAIN_STEPS for k, n in per_step.items()}
        ms_step = 1e3 * train_seconds / TRAIN_STEPS
        print(f"  {card}: {TRAIN_STEPS} steps at batch "
              f"{TRAIN_BATCH} (update_many k={TRAIN_K}), {ms_step:.3f} ms/step, "
              f"{TRAIN_BATCH * TRAIN_STEPS / train_seconds:.1f} images/s", flush=True)
        print(f"  launches {train_launches}, expected {train_expected}", flush=True)
        if train_launches != train_expected:
            raise SystemExit("the training path did not launch each kernel as expected")
        losses = torch.cat([warm["loss"], timed_metrics["loss"]])
        after = ocr.module.state_dict()
        moved = {GROUP_OF[k.split(".")[0]] for k in after
                 if not torch.equal(after[k], start[k])}
        print(f"  loss on one fixed batch: step 0 {losses[0].item():.4f}, step "
              f"{len(losses) - 1} {losses[-1].item():.4f}; groups moved {sorted(moved)}; "
              f"norm {timed_metrics['norm'][-1].item():.4f}, tau "
              f"{timed_metrics['tau'][-1].item():.6f}", flush=True)
        if not (torch.isfinite(losses).all() and losses[-1] < losses[0]
                and moved == set(GROUP_OF.values())):
            raise SystemExit("training did not lower the loss or move every group")

    if args.profile:
        with phase("profile"):
            for E in BATCHES:
                obs = requests[E][0]
                profile(f"E={E}: 5 requests", lambda: algo.predict(obs), 5, 15)
            superbatch = np.concatenate([batch] * TRAIN_K)
            profile(f"training: {2 * TRAIN_K} steps",
                    lambda: ocr.update_many(superbatch, None, 0, TRAIN_K), 2, 25)

    def row(name, source, replaces, result):
        # launches: summed over the two main-path runs, serving and training
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches.get(name, 0) + train_launches.get(name, 0),
                    max_abs_err=result["max_abs_err"], ms=result["ms"],
                    plain_ms=result["plain_ms"], bound_ms=result["bound_ms"],
                    bound_by=result["bound_by"], library_ms=None)

    routing, gumbel_cu = ("ocrl_tpu_torch/ops/csrc/slot_routing.cu",
                          "ocrl_tpu_torch/ops/csrc/gumbel.cu")
    kernels = [
        row(gumbel.SOFT_KERNEL, gumbel_cu, "ocrl_tpu/ops/gumbel.py:50",
            soft_ids[gumbel.SOFT_KERNEL]),
        row(gumbel.IDS_KERNEL, gumbel_cu, "ocrl_tpu/ops/gumbel.py:112",
            soft_ids[gumbel.IDS_KERNEL]),
        row(slot_routing.KERNEL, routing, "ocrl_tpu/ops/slot_routing.py:79", sweep),
        row(slot_routing.BWD_KERNEL, routing, "ocrl_tpu/ops/slot_routing.py:86", sweep_bwd),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
