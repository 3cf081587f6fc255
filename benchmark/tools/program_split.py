"""One traced run of a cell, split by the program's own spans.

    python3 benchmark/tools/program_split.py --workload <cell> --seed <n>
        --seconds <s> [--spans 0|1] [--out FILE]

Runs the cell as ``run.py --trace 1`` does, in this process, and reads the
traced window's events a second time through ``benchcore.program``: the
readings of ``program.readings``, the kernel milliseconds by the innermost
program span open at their launch (a step's or an update's share), the ten
longest idle gaps named by the program's spans, the traced wall a step, and
the result line's own numbers. ``--spans 0`` turns the program's spans off
(``ocrl_tpu_torch.utils.tracing.span`` made a null context for the run), so
that two runs show what the spans cost while a profiler records. Prints one
JSON line; ``--out`` writes it to a file as well.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.time()

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))

from benchcore import main as harness  # noqa: E402
from benchcore import program  # noqa: E402
from benchcore import trace as tracing  # noqa: E402


def split(result: dict, seen: program.Program) -> dict:
    """The program's view of one traced run beside its result line."""
    roots = [n for n in ("step", "update") if program.count(seen, n)]
    steps = program.count(seen, roots[0]) if roots else 0
    by_span = program.device_ms_by_span(seen)
    total = sum(by_span.values())
    under_root = sum(program.device_ms_under(seen, {r}) for r in roots)
    out = {"readings": program.readings(seen),
           "steps": steps, "root": roots[0] if roots else None,
           "kernel_ms": total,
           "share_under_root": under_root / total if total else None,
           "kernel_ms_by_span": by_span,
           "spans_ms": {n: program.span_ms(seen, {n}) for n in sorted({s[0] for s in seen.spans})},
           "span_counts": {n: program.count(seen, n) for n in sorted({s[0] for s in seen.spans})},
           "traced_wall_ms_a_step": ((seen.window[1] - seen.window[0]) / 1e3 / steps
                                     if steps else None),
           "idle_gaps": program.program_idle_gaps(seen),
           "correct": result["correct"], "metrics": result["metrics"],
           "device": result["device"], "breakdown": result.get("breakdown")}
    if "step" in roots:
        phases = sum(program.device_ms_under(seen, {p})
                     for p in ("forward", "backward", "optimizer"))
        out["phases_over_step_device"] = phases / total if total else None
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--spans", type=int, choices=(0, 1), default=1)
    parser.add_argument("--out")
    args = parser.parse_args()

    seen: list[program.Program] = []
    parse = tracing.parse

    def both(events):
        seen.append(program.parse(events))
        return parse(events)

    tracing.parse = both
    if not args.spans:
        from ocrl_tpu_torch.utils import tracing as port_tracing
        port_tracing.span = lambda name: contextlib.nullcontext()
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, True, T_START)
    for line in lines:
        print(line, file=sys.stderr)
    out = {"workload": args.workload, "seed": args.seed, "spans": bool(args.spans),
           **split(result, seen[-1])}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
