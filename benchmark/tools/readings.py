"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,...
        [--fault-seeds 1,2,3] [--out FILE]

For each seed, the runner's ``readings``: the program against the reference
(the lower readings), and on the fault seeds the control and the planted
faults against the reference (the upper readings). Prints a JSON line a
seed and a summary: the largest program reading and the smallest control
and fault reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchcore.main import make_context  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--out")
    args = parser.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | fault_seeds, key=lambda s: (s not in fault_seeds, s)):
        t0 = time.time()
        _, _, runner, ctx = make_context(args.workload, seed, 0.0, False, t0)
        got = runner.readings(ctx, seed in fault_seeds)
        row = {"seed": seed, "seconds": time.time() - t0, **got}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary: dict = {}
    for side in ("program", "control", "half_batch"):
        sides = [r[side] for r in rows if side in r]
        if sides:
            pick = max if side == "program" else min
            summary[side] = {k: pick(s[k] for s in sides) for k in sides[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
