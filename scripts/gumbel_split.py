#!/usr/bin/env python3
"""Where the time of the Gumbel id kernel (B2) goes, on one NVIDIA GPU.

    python3 scripts/gumbel_split.py          # this checkout's gumbel.cu
    python3 scripts/gumbel_split.py parent=OTHER/gumbel.cu \
        change=ocrl_tpu_torch/ops/csrc/gumbel.cu

Each source (LABEL=PATH, with the C interface of
``ocrl_tpu_torch/ops/csrc/gumbel.cu``) is built by nvcc into
``build/gumbel_split/`` in three variants, made from its text and never kept
in the tree:

- ``as_is``;
- ``stream``: the noise made a constant zero (``gumbel_of`` returns 0, and
  the Philox words it took are dead code), so that the kernel reads and
  compares the logits only;
- ``arithmetic``: the logits made a constant zero (every ``lr[c4]``), so that
  it draws and compares the noise only.

It then times ``gumbel_ids`` of every variant at [6144, 4096] (the SLATE
training step's logits) and [1000, 512], and ``gumbel_soft`` of each source
as it is, by CUDA events around 200 launches, in rounds that take every
source and variant in turn, forwards and backwards in alternate rounds;
counts the SASS instructions of
``gumbel_ids_kernel<4>`` (cuobjdump; 16 values a thread at V = 4096) by
opcode; and holds the field each source's two kernels draw (``g_out``)
against ``ops.gumbel.replay_field``, the numpy replay of their Philox field.
It prints the card's name and power limit, one line per measurement and, last,
one JSON object of all of them. It needs a card, nvcc and cuobjdump.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ocrl_tpu_torch.ops import _build, gumbel  # noqa: E402

OUT = ROOT / "build" / "gumbel_split"
SHAPES = ((6144, 4096), (1000, 512))
CHECK_SHAPES = ((6144, 4096), (1000, 512), (7, 32))
SEED = 0x2545F4914F6CDD1D
ROUNDS, REPS = 5, 200
ZERO4 = "make_float4(0.f, 0.f, 0.f, 0.f)"


def variants(src: str) -> dict[str, str]:
    """The three variants of one source's text."""
    noise = "float gumbel_of(uint32_t bits) {"
    stream = src.replace(noise, noise + "\n  return 0.f;", 1)
    arithmetic = re.sub(r"\blr\[c4\]", ZERO4, src)
    if stream == src or arithmetic == src:
        raise SystemExit("no gumbel_of or no lr[c4] load to replace")
    return {"as_is": src, "stream": stream, "arithmetic": arithmetic}


def build(sources: dict[str, Path]) -> dict[tuple[str, str], Path]:
    """Every variant of every source, one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for label, path in sources.items():
        for name, text in variants(path.read_text()).items():
            cu = OUT / f"{label}-{name}.cu"
            cu.write_text(text)
            lib = cu.with_suffix(".so")
            jobs[label, name] = (subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        usage = _build.ptxas_usage(log)
        registers = {k: u["registers"] for k, u in usage.items() if k.endswith("<4>")}
        spills = [k for k, u in usage.items() if u["spill_stores"] or u["spill_loads"]]
        print(f"  ptxas {key[0]} {key[1]}: registers {registers}, spills in "
              f"{spills or 'none'}", flush=True)
        libs[key] = lib
    return libs


def entries(lib: Path):
    """The two C entries of a built variant, and the type of its ids."""
    dll = ctypes.CDLL(str(lib))
    source = lib.with_suffix(".cu").read_text()
    wide = re.search(r"gumbel_ids\([^)]*int64_t\* ids", source)
    # sources before the row offset have no row0 before the stream
    row0 = re.search(r"gumbel_ids\([^)]*int row0", source) is not None
    fns = {"ids_dtype": torch.int64 if wide else torch.int32, "row0": row0}
    for name in (gumbel.SOFT_KERNEL, gumbel.IDS_KERNEL):
        fn = getattr(dll, name)
        types = list(gumbel._ARGTYPES[name])
        fn.argtypes, fn.restype = types if row0 else types[:-2] + types[-1:], ctypes.c_int
        fns[name] = fn
    return fns


def caller(fns, name, logits, seed, g_out=None):
    """A launch of entry ``name`` on ``logits``; raises on a launch error."""
    R, V = logits.shape
    fn = fns[name]
    out = torch.empty_like(logits) if name == gumbel.SOFT_KERNEL else \
        torch.empty(R, dtype=fns["ids_dtype"], device=logits.device)
    extra = ((0.55,) if name == gumbel.SOFT_KERNEL else ()) + ((0,) if fns["row0"] else ())
    g_ptr = None if g_out is None else g_out.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(logits.data_ptr(), None, out.data_ptr(), g_ptr, seed.data_ptr(),
                 R, V, *extra, stream)
        if err:
            raise SystemExit(f"{name}: CUDA launch failed with error {err}")
        return out
    return launch


def ms_per_launch(launch, reps: int = REPS) -> float:
    for _ in range(20):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_counts(lib: Path) -> dict[str, int]:
    """Opcodes (without modifiers) of gumbel_ids_kernel<4>, NOPs left out;
    its SASS is written beside the library (``.sass``)."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, int] = {}
    for block in dump.split("Function : ")[1:]:
        if "gumbel_ids_kernelILi4E" not in block.split("\n", 1)[0]:
            continue
        lib.with_suffix(".sass").write_text(block)
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)",
                             block):
            if m.group(1) != "NOP":
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    if not counts:
        raise SystemExit(f"no gumbel_ids_kernel<4> in {lib}")
    return counts


def check_fields(fns, label: str, gen) -> dict:
    """Each kernel's g_out against the replayed field; B2's ids against the
    plain argmax of logits + g_out."""
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda")
    worst, top = 0.0, -float("inf")
    for R, V in CHECK_SHAPES:
        logits = torch.randn(R, V, device="cuda", generator=gen) * 3
        for name, stream in ((gumbel.SOFT_KERNEL, gumbel.SOFT_STREAM),
                             (gumbel.IDS_KERNEL, gumbel.IDS_STREAM)):
            g = torch.empty_like(logits)
            out = caller(fns, name, logits, seed, g)()
            exact = torch.from_numpy(gumbel.replay_field(SEED, stream, R, V))
            dev = (g.cpu().double() - exact).abs().max().item()
            worst, top = max(worst, dev), max(top, g.max().item())
            same = ""
            if name == gumbel.IDS_KERNEL:
                equal = torch.equal(out.long(), torch.argmax(logits + g, -1))
                same = f", ids {'equal' if equal else 'DIFFER'}"
            print(f"  {label} {name} [{R}, {V}]: max |g - replay| {dev:.3e}, "
                  f"largest g {g.max().item():.6f}{same}", flush=True)
    return {"max_abs_dev": worst, "largest_g": top}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:] or [f"tree={ROOT / 'ocrl_tpu_torch/ops/csrc/gumbel.cu'}"]
    sources = {a.split("=", 1)[0]: Path(a.split("=", 1)[1]) for a in args}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build(sources)
    fns = {key: entries(lib) for key, lib in libs.items()}
    result = {"card": card, "sass": {}, "fields": {}, "ms": {}}
    for label in sources:
        counts = sass_counts(libs[label, "as_is"])
        total = sum(counts.values())
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
        print(f"  SASS {label} gumbel_ids_kernel<4>: {total} instructions, "
              f"{total / 16:.1f} a value; {top}", flush=True)
        result["sass"][label] = dict(total=total, per_value=total / 16, opcodes=counts)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label in sources:
        result["fields"][label] = check_fields(fns[label, "as_is"], label, gen)
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda")
    for R, V in SHAPES:
        logits = torch.randn(R, V, device="cuda", generator=gen) * 3
        launches = {(label, name, kernel): caller(fns[label, name], kernel, logits, seed)
                    for (label, name) in libs
                    for kernel in (gumbel.IDS_KERNEL, gumbel.SOFT_KERNEL)
                    if kernel == gumbel.IDS_KERNEL or name == "as_is"}
        times: dict = {key: [] for key in launches}
        order = list(launches.items())
        for r in range(ROUNDS):
            for key, launch in (order if r % 2 == 0 else order[::-1]):
                times[key].append(ms_per_launch(launch))
        for (label, name, kernel), ms in times.items():
            print(f"  [{R}, {V}] {label} {name} {kernel}: device ms "
                  f"{statistics.median(ms):.4f} (rounds {', '.join(f'{t:.4f}' for t in ms)})",
                  flush=True)
            result["ms"][f"{R}x{V} {label} {name} {kernel}"] = ms
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
