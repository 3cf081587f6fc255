"""Runs of one cell in a row, each a process of its own, and their spread.

    python3 benchmark/tools/series.py --workload <cell> --seeds 1,2,3
        --seconds S [--trace 0|1] [--out FILE]

Prints each run's exit code, seconds and last line, then for each metric
its values, median and spread: (q3 - q1) / median, the quartiles of
``statistics.quantiles(values, n=4)``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", required=True)
    parser.add_argument("--trace", default="0")
    parser.add_argument("--timeout", type=float, default=1300)
    parser.add_argument("--out")
    args = parser.parse_args()
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, "benchmark/run.py", "--workload", args.workload, "--seed", seed,
               "--seconds", args.seconds, "--trace", args.trace]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=args.timeout)
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        run = {"seed": int(seed), "rc": proc.returncode, "seconds": time.time() - t0,
               "result": result, "stderr_tail": proc.stderr[-2500:]}
        runs.append(run)
        print(json.dumps({k: v for k, v in run.items() if k != "stderr_tail"}), flush=True)
        if proc.returncode != 0 or result is None:
            print(proc.stderr[-4000:], flush=True)
    metrics: dict[str, list[float]] = {}
    for run in runs:
        for name, m in ((run["result"] or {}).get("metrics") or {}).items():
            metrics.setdefault(name, []).append(m["value"])
    summary = {name: {"values": v, "median": statistics.median(v), "spread": spread(v)}
               for name, v in metrics.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
