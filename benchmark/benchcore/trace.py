"""The device trace of a traced window, and what is read from it.

``start(device)`` starts torch.profiler (host and device activity);
``from_profiler(prof, workdir)`` writes the stopped session's Chrome trace
into ``workdir``, reads it back and deletes it. A ``Trace`` holds the device operations (kernels, copies and
fills, with their launch's host time where the trace links them), the
harness's host spans (``torch.profiler.record_function`` ranges named
``bench.<span>``) and the traced window, the ``bench.window`` span.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
WINDOW_SPAN = "window"
TOP = 10
NAME_CHARS = 160


@dataclass
class Op:
    name: str
    start: float        # microseconds on the trace's clock
    end: float
    cat: str
    launched: float | None = None   # host time of the launch, where linked


@dataclass
class Trace:
    ops: list[Op] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    window: tuple[float, float] = (0.0, 0.0)

    @property
    def kernels(self) -> list[Op]:
        """The kernels that started inside the window."""
        lo, hi = self.window
        return [op for op in self.ops if op.cat == "kernel" and lo <= op.start < hi]

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals, so overlapping streams count once)."""
        return sum(b - a for a, b in merged(self.ops, *self.window)) / 1e6

    def span_at(self, t: float) -> str:
        """The innermost harness span open at host time ``t``."""
        best = None
        for name, a, b in self.spans:
            if a <= t < b and name != WINDOW_SPAN and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "none"

    def span_over(self, a: float, b: float) -> str:
        """The harness span that covers most of the host interval [a, b]."""
        best, most = "none", 0.0
        for name, lo, hi in self.spans:
            cover = min(b, hi) - max(a, lo)
            if name != WINDOW_SPAN and cover > most:
                best, most = name, cover
        return best

    def idle_gaps(self) -> list[tuple[str, float]]:
        """The device's idle gaps inside the window, longest first, each
        named by the host span that covers most of it: (name, seconds)."""
        lo, hi = self.window
        gaps, at = [], lo
        for a, b in merged(self.ops, lo, hi):
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [(self.span_over(a, b), (b - a) / 1e6) for a, b in gaps]

    def top_ops(self) -> list[tuple[str, float]]:
        """Device time by operation name inside the window, largest first."""
        totals: dict[str, float] = {}
        lo, hi = self.window
        for op in self.ops:
            a, b = max(op.start, lo), min(op.end, hi)
            if b > a:
                totals[op.name] = totals.get(op.name, 0.0) + (b - a) / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        return {"device_ops": [[name[:NAME_CHARS], s] for name, s in self.top_ops()[:TOP]],
                "idle_gaps": [[name, s] for name, s in self.idle_gaps()[:TOP]]}


def merged(ops: list[Op], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the ops' intervals, clipped to [lo, hi], in order."""
    spans = sorted((max(op.start, lo), min(op.end, hi)) for op in ops)
    out: list[list[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def parse(events: list[dict]) -> Trace:
    """A Trace of a Chrome trace's events."""
    launches: dict[int, float] = {}
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append(Op(name, ts, ts + dur, cat, args.get("correlation")))
        elif cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], ts, ts + dur))
    for op in ops:
        op.launched = launches.get(op.launched) if op.launched is not None else None
    trace = Trace(ops, spans)
    windows = [(a, b) for name, a, b in spans if name == WINDOW_SPAN]
    if windows:
        trace.window = (min(a for a, _ in windows), max(b for _, b in windows))
    return trace


def start(device):
    """A started torch.profiler session of host and (on a card) device
    activity; stop it and read it with ``from_profiler``."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def from_profiler(prof, workdir: Path) -> Trace:
    """The Trace of a stopped torch.profiler session."""
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return parse(events)
