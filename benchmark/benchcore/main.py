"""One run of one cell of the benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix. Everything that belongs to one of them is found by name:

- ``benchmark/configs/<config>.json``: the configuration as it is run, and
  ``benchmark/configs/<config>.py`` beside it: the program's overrides, the
  model's FLOPs and its plain reference;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, whose
  ``runner`` names ``benchmark/runners/<runner>.py``, the code that sets the
  program up, drives its timed window and checks what it produced;
- ``benchmark/cells/<cell>.json``: the limits of the cell's ``correct``;
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

The run prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers close standard error.
Without a CUDA card (or with fewer than the cell asks for) it prints no
result and exits 2; if a JAX module is loaded once the window has closed it
names it and exits 3.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ocrl_tpu")


@dataclass
class Context:
    """What a runner is handed: the cell, its configuration (``m``, the
    JSON file's values; ``cfgmod``, the module beside it), its traffic,
    the run's seed and length, and where it may write."""
    workload: str
    m: dict
    cfgmod: object
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: Path
    limits: dict
    t_start: float


@dataclass
class Outcome:
    """What a runner returns: the end-to-end values by name, the record
    the per-layer readers read, the checks (name, value, limit), the
    attempted and failed counts, the peak device memory and, traced, the
    Trace."""
    end_to_end: dict
    record: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None
    errors: list = field(default_factory=list)
    setup_phases: dict = field(default_factory=dict)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX one, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def make_context(workload: str, seed: int, seconds: float, trace: bool, t_start: float, *,
                 device=None, m_overrides: dict | None = None,
                 traffic_overrides: dict | None = None, workdir: Path | None = None):
    """(BENCHMARK.json, the cell's entry, the runner module, the Context)."""
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    m = json.loads((ROOT / config["file"]).read_text())
    m.update(m_overrides or {})
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    cfgmod = load_module((ROOT / config["file"]).with_suffix(".py"), f"benchcfg_{cell['config']}")
    runner = load_module(BENCH_DIR / "runners" / f"{traffic['runner']}.py",
                         f"benchrun_{traffic['runner']}")
    limits = json.loads((BENCH_DIR / "cells" / f"{workload}.json").read_text())["limits"]
    base = Path(os.environ.get("TMPDIR") or ROOT / "build")
    ctx = Context(workload, m, cfgmod, traffic, int(seed), float(seconds), bool(trace),
                  torch.device(device or "cuda"), workdir or base / "ocrl-benchmark", limits,
                  t_start)
    return bench, cell, runner, ctx


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, **kwargs):
    """Set the cell up, run it, and return (the result's dict, the check
    lines). ``make_context``'s keywords (``device``, ``m_overrides``,
    ``traffic_overrides``, ``workdir``) serve the benchmark's own tests, a
    small run on the CPU."""
    import torch

    bench, cell, runner, ctx = make_context(workload, seed, seconds, trace, t_start, **kwargs)
    out: Outcome = runner.run(ctx)

    checks = [(name, float(value), float(limit)) for name, value, limit in out.checks]
    correct = (not out.errors and bool(checks)
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))
    metrics = {}
    if trace:
        for spec in cell_metrics(bench, workload, "per_layer"):
            reader = load_module(BENCH_DIR / "metrics" / f"{spec['name']}.py",
                                 "benchmetric_" + spec["name"].replace(".", "_"))
            value = reader.read(out.record)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    else:
        for spec in cell_metrics(bench, workload, "end_to_end"):
            if spec["name"] in out.end_to_end:
                metrics[spec["name"]] = {"value": float(out.end_to_end[spec["name"]]),
                                         "unit": spec["unit"]}
    dev = torch.device(ctx.device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device_info}
    if trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s()
        device_info["window_s"] = out.trace.window_s()
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    lines = ["setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in out.setup_phases.items())]
    lines += [f"error: {e}" for e in out.errors]
    lines += [f"check {name}: {v!r} (limit {lim!r})" for name, v, lim in checks]
    return result, lines


def main(argv, t_start: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload '{args.workload}' in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
