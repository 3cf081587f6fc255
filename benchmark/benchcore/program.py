"""The program's own spans in a traced window, and what is read from them.

The port marks the phases of its steps as ``torch.profiler.record_function``
ranges named ``ocrl.<span>`` while a profiler records
(``ocrl_tpu_torch/utils/tracing.py``: ``step`` around ``forward``,
``backward`` and ``optimizer``; ``update`` around its ``optimizer``;
``sample``, ``upload``, ``env_wait``). ``parse(events)`` reads a Chrome
trace's events into a ``Program``: those ranges, the device operations, each
linked to the host time of its launch through the correlation of a
``cuda_runtime`` or a ``cuda_driver`` record (cuDNN and cuBLAS may call
``cuLaunchKernel`` directly), and the traced window, the harness's ``bench.window``
span. The harness's own ``trace.parse`` keeps neither the program's ranges
nor the ``cuda_driver`` launches; it reads the same events as it always has.

A kernel belongs to the spans open at its launch: a backward's kernels,
launched by autograd's thread, lie under ``ocrl.backward``, whose range on
the calling thread lasts until the backward has been launched.
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field

from benchcore.trace import DEVICE_CATS, SPAN_PREFIX, TOP, WINDOW_SPAN, Op, merged

PROGRAM_PREFIX = "ocrl."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Program:
    """The device operations, the program's spans (name without the prefix,
    host start, host end; in order of start, the outer first) and the
    window, all on the trace's clock in microseconds."""

    ops: list[Op] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    window: tuple[float, float] = (0.0, 0.0)

    @property
    def kernels(self) -> list[Op]:
        """The kernels that started inside the window."""
        lo, hi = self.window
        return [op for op in self.ops if op.cat == "kernel" and lo <= op.start < hi]

    def in_window(self, names) -> list[tuple[str, float, float]]:
        """The spans of those names that started inside the window."""
        lo, hi = self.window
        return [s for s in self.spans if s[0] in names and lo <= s[1] < hi]


def parse(events: list[dict]) -> Program:
    """A Program of a Chrome trace's events."""
    launches: dict[int, tuple[int, float]] = {}
    ops, spans, windows = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append(Op(name, ts, ts + dur, cat, args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            # where both records carry one launch, the runtime's (the outer call)
            rank = LAUNCH_CATS.index(cat)
            known = launches.get(args["correlation"])
            if known is None or rank < known[0]:
                launches[args["correlation"]] = (rank, ts)
        elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            spans.append((name[len(PROGRAM_PREFIX):], ts, ts + dur))
        elif cat == "user_annotation" and name == SPAN_PREFIX + WINDOW_SPAN:
            windows.append((ts, ts + dur))
    for op in ops:
        link = launches.get(op.launched) if op.launched is not None else None
        op.launched = None if link is None else link[1]
    window = (min(a for a, _ in windows), max(b for _, b in windows)) if windows else (0.0, 0.0)
    return Program(ops, sorted(spans, key=lambda s: (s[1], -s[2])), window)


def _union(spans: list[tuple[str, float, float]]) -> tuple[list[float], list[float]]:
    """The union of the spans' host intervals: (starts, ends), in order."""
    starts: list[float] = []
    ends: list[float] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def device_ms_under(program: Program, names) -> float:
    """Milliseconds of the window's kernels launched inside a span of those
    names (kernels only, as ``step_device_ms`` counts them)."""
    starts, ends = _union([s for s in program.spans if s[0] in names])
    total = 0.0
    for op in program.kernels:
        if op.launched is not None:
            i = bisect.bisect_right(starts, op.launched) - 1
            if i >= 0 and op.launched < ends[i]:
                total += op.end - op.start
    return total / 1e3


def device_ms_by_span(program: Program) -> dict[str, float]:
    """The window's kernel milliseconds by the innermost program span open
    at their launch: ``none`` outside every span, ``unlinked`` where the
    trace links no launch."""
    starts = [a for _, a, _ in program.spans]
    reach = list(itertools.accumulate((b for _, _, b in program.spans), max))
    out: dict[str, float] = {}
    for op in program.kernels:
        name = "unlinked" if op.launched is None else _innermost(program, starts, reach,
                                                                 op.launched)
        out[name] = out.get(name, 0.0) + (op.end - op.start) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _innermost(program: Program, starts: list[float], reach: list[float], t: float) -> str:
    """The innermost span open at host time ``t``: the latest started that
    is still open (``reach[i]``, the latest end among spans 0..i, stops the
    search once nothing earlier can be open)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] > t:
        name, _, b = program.spans[i]
        if t < b:
            return name
        i -= 1
    return "none"


def span_ms(program: Program, names) -> float:
    """The summed milliseconds of the spans of those names that started
    inside the window."""
    return sum(b - a for _, a, b in program.in_window(names)) / 1e3


def count(program: Program, name: str) -> int:
    """How many spans of that name started inside the window."""
    return len(program.in_window({name}))


def program_idle_gaps(program: Program, top: int = TOP) -> list[tuple[str, float]]:
    """The ``top`` longest idle gaps of the device inside the window, longest
    first, each named by the innermost program span among those that cover
    most of it: (name, seconds)."""
    lo, hi = program.window
    gaps, at = [], lo
    for a, b in merged(program.ops, lo, hi):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [(_cover(program, a, b), (b - a) / 1e6) for a, b in gaps[:top]]


def _cover(program: Program, a: float, b: float) -> str:
    best, most = "none", (0.0, 0.0, 0.0)
    for name, lo, hi in program.spans:
        key = (min(b, hi) - max(a, lo), lo, -hi)
        if key[0] > 0 and key > most:
            best, most = name, key
    return best


def _per(total: float, n: int) -> float | None:
    return total / n if n and total > 0 else None


def readings(program: Program) -> dict[str, float]:
    """What the program's spans say of a cell's steps, by the name a
    per-layer metric of it would take: kernel ms a pretraining step under
    ``forward``, ``backward`` and ``optimizer``; an SAC vector step's
    ``env_wait`` ms, an update's ``sample`` + ``upload`` ms and its kernel
    ms under ``optimizer``. A reading whose spans the window lacks is left
    out."""
    steps, updates, waits = (count(program, n) for n in ("step", "update", "env_wait"))
    got = {f"{phase}_device_ms.pretrain": _per(device_ms_under(program, {phase}), steps)
           for phase in ("forward", "backward", "optimizer")}
    got["env_wait_ms.rl"] = _per(span_ms(program, {"env_wait"}), waits)
    got["sample_ms.rl"] = _per(span_ms(program, {"sample", "upload"}), updates)
    got["optimizer_device_ms.rl"] = _per(device_ms_under(program, {"optimizer"}), updates)
    return {k: v for k, v in got.items() if v is not None}
