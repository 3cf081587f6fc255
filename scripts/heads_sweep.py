#!/usr/bin/env python3
"""Time the routing sweep's kernels of one or more slot_routing.cu sources
side by side on one NVIDIA GPU.

    python3 scripts/heads_sweep.py                      # this checkout's source
    python3 scripts/heads_sweep.py parent=OTHER/slot_routing.cu \\
        change=ocrl_tpu_torch/ops/csrc/slot_routing.cu
    python3 scripts/heads_sweep.py --phases change=...   # also where the time goes

Each source (LABEL=PATH, with the C entries of
``ocrl_tpu_torch/ops/csrc/slot_routing.cu``) is built by nvcc into
``build/heads_sweep/`` (all together; each one's seconds and its kernels'
registers and spill bytes are printed). Then, at every shape of
``chip_smoke.HEADS_SHAPES`` (the heads entry, B3' and B4') and at the
single-head shapes of the main path (B3 at B = 16, 24 and 256, B4 at 24 and
256; N = 4096, 5 slots of 192), each source's forward and backward entries
run on the same inputs (made from a seeded generator): every output within
``chip_smoke.SWEEP_TOL`` of the plain version's largest entry (the plain
sweep and its autograd) and a second launch bitwise equal. Their device
time a call (both kernels of an entry, and the sweep kernel alone,
torch.profiler) is taken in ROUNDS
rounds that visit the sources forwards and backwards in turn, beside the
plain version's and the bound (``chip_smoke.sweep_bound_ms``,
``sweep_bwd_bound_ms``). Where a source has ``slot_routing_heads_plan``, the
plan its heads entries choose is printed for each heads shape. With
``--phases`` each source is also built with a clock64 mark at every phase
boundary of the heads kernels' consumer loops (``with_phases``: waiting for
a tile, the logits, the softmax or dl, the barrier, the columns, a
segment's end), and the cycles a consumer warp spends in each are printed
for every heads shape; those copies are checked but not timed. It prints
the card's name and power limit, one line per measurement and, last, one
JSON object of all of them. It needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ocrl_tpu_torch.ops import _build, slot_routing as tsr  # noqa: E402

OUT = ROOT / "build" / "heads_sweep"
SINGLE_FWD = [(16, 4096, 5, 1, 192), (24, 4096, 5, 1, 192), (256, 4096, 5, 1, 192)]
SINGLE_BWD = [(24, 4096, 5, 1, 192), (256, 4096, 5, 1, 192)]
ROUNDS, REPS = 5, 20
PHASES_FLAG = "--phases"


PHASES = ("row and loop", "wait for the tile", "logits", "softmax or dl", "barrier",
          "columns", "segment end")
MARKS = [   # (text in each heads kernel's consumer loop, the mark before / after it)
    ("    const int st = i % stages;\n    mbar_wait(&full[st], (i / stages) & 1);\n", 0, 1),
    ("    __syncwarp();\n", None, 2),
    ("    consumer_sync();\n\n", 3, 4),
    ("    release(&empty[st]);\n", 5, None),
    ("    fresh = it.ends_segment();\n", 6, None),
]


def with_phases(text: str) -> str:
    """The source with a clock64 mark at each phase boundary of the heads
    kernels' consumer loops: lane 0 of each consumer warp adds the cycles
    since its last mark to heads_phase_cycles[kernel][block][warp][phase],
    which ``heads_phases`` copies out and clears."""
    head = ("__device__ unsigned long long heads_phase_cycles[2][256][8][8];\n"
            'extern "C" int heads_phases(unsigned long long* out) {\n'
            "  static unsigned long long zeros[2 * 256 * 8 * 8];\n"
            "  cudaError_t err = cudaMemcpyFromSymbol(out, heads_phase_cycles, sizeof(zeros));\n"
            "  if (err != cudaSuccess) return static_cast<int>(err);\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(heads_phase_cycles, zeros,"
            " sizeof(zeros)));\n}\n")
    text = text.replace("namespace {\n", head + "\nnamespace {\n", 1)
    for kernel, k in (("heads_fwd_kernel(", 0), ("heads_bwd_kernel(", 1)):
        start = text.index(kernel)
        end = text.index("\n}\n", start)
        body = text[start:end]
        anchor = "  const int warp = tid >> 5, lane = tid & 31;\n"
        body = body.replace(anchor, (
            anchor + "  long long phase_t = clock64();\n"
            "  auto mark = [&](int ph) {\n"
            "    if ((threadIdx.x & 31) == 0 && blockIdx.x < 256) {\n"
            "      const long long now = clock64();\n"
            f"      heads_phase_cycles[{k}][blockIdx.x][threadIdx.x >> 5][ph] += now - phase_t;\n"
            "      phase_t = now;\n    }\n  };\n"), 1)
        for anchor, before, after in MARKS:
            if body.count(anchor) < 1:
                raise SystemExit(f"no '{anchor.strip()}' in {kernel}")
            i = body.rindex(anchor) if anchor.startswith("    consumer_sync") else \
                body.index(anchor)
            body = (body[:i] + (f"    mark({before});\n" if before is not None else "")
                    + anchor + (f"    mark({after});\n" if after is not None else "")
                    + body[i + len(anchor):])
        text = text[:start] + body + text[end:]
    return text


def build(sources: dict[str, Path]) -> dict[str, Path]:
    """Every source, one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    t0 = time.perf_counter()
    if PHASES_FLAG in sys.argv:
        for label in list(sources):
            if "struct TileOut" not in sources[label].read_text():
                print(f"  {label}: no phase marks (its heads kernels predate the layout "
                      "with_phases reads)", flush=True)
                continue
            copy = OUT / f"{label}-phases.cu"
            copy.write_text(with_phases(sources[label].read_text()))
            sources[f"{label}-phases"] = copy
    jobs = {label: (subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"{label}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), OUT / f"{label}.so")
        for label, path in sources.items()}
    libs = {}
    for label, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {label}:\n{log}")
        usage = _build.ptxas_usage(log)
        heads = {k: (u["registers"], u["spill_stores"] + u["spill_loads"])
                 for k, u in usage.items() if k.startswith("heads_")}
        print(f"  nvcc {label}: {time.perf_counter() - t0:.2f} s; heads kernels "
              f"(registers, spill bytes): {heads}; stack frames: "
              f"{sorted(set(re.findall(r'(\d+) bytes stack frame', log)))}", flush=True)
        sass_counts(label, lib)
        libs[label] = lib
    return libs


def sass_counts(label: str, lib: Path) -> None:
    """Instructions of each heads kernel in its SASS (cuobjdump), by kind:
    all, FFMA, shared (LDS, STS), generic (LD, ST) and global (LDG, STG)
    memory, SHFL, BAR and local-memory LDL / STL."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = _build._short_name(part.split()[0])
        if not name.startswith("heads_"):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part)
        kinds = {k: sum(op.split(".")[0] == k for op in ops)
                 for k in ("FFMA", "LDS", "STS", "LD", "ST", "LDG", "STG", "SHFL", "BAR",
                           "LDL", "STL")}
        print(f"    sass {label} {name}: {len(ops)} instructions, {kinds}", flush=True)


def entries(lib: Path) -> dict:
    dll = ctypes.CDLL(str(lib))
    fns = {"dll": dll}
    for name in (tsr.KERNEL, tsr.BWD_KERNEL, tsr.HEADS_KERNEL, tsr.HEADS_BWD_KERNEL,
                 tsr.HEADS_PLAN):
        fn = getattr(dll, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = tsr._ARGTYPES[name], ctypes.c_int
            fns[name] = fn
    return fns


def inputs(shape, seed: int) -> dict:
    B, N, S, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s):
        return torch.randn(*s, device="cuda", generator=gen)
    k = r(B, N, D) * (D // H) ** -0.5
    x = dict(k=k, v=r(B, N, D), q=r(B, S, D), g_sa=r(B, H * S), g_av=r(B, S, D),
             g_a=r(B, N, H * S))
    x["a"] = tsr.route_sweep_reference(x["k"], x["v"], x["q"], H)[2].contiguous()
    x["g_af"] = (x["g_a"] + x["g_sa"][:, None, :]).contiguous()
    return x


def forward_call(fns, shape, x):
    """One launch of the forward entry that takes the shape: (sa, av, a)."""
    B, N, S, H, D = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    HS = H * S
    a, sa = torch.empty(B, N, HS, device="cuda"), torch.empty(B, HS, device="cuda")
    av = torch.empty(B, S, D, device="cuda")
    scratch = torch.empty(tsr.scratch_rows(B, N, sms), S * D + tsr._padded(HS), device="cuda")
    fast = tsr.fast_path(S, D, H)
    fn = fns[tsr.KERNEL if fast else tsr.HEADS_KERNEL]
    shape_args = (B, N, S, D, sms) if fast else (B, N, S, D, H, sms)

    def call():
        err = fn(x["k"].data_ptr(), x["v"].data_ptr(), x["q"].data_ptr(), a.data_ptr(),
                 sa.data_ptr(), av.data_ptr(), scratch.data_ptr(), *shape_args,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"forward at {shape}: CUDA error {err}")
        return sa, av, a
    return call


def backward_call(fns, shape, x):
    """One launch of the backward entry that takes the shape: (gk, gv, gq)."""
    B, N, S, H, D = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gk, gv = torch.empty_like(x["k"]), torch.empty_like(x["v"])
    gq = torch.empty_like(x["q"])
    scratch = torch.empty(tsr.scratch_rows(B, N, sms), S * D, device="cuda")
    fast = tsr.fast_path(S, D, H)
    fn = fns[tsr.BWD_KERNEL if fast else tsr.HEADS_BWD_KERNEL]
    shape_args = (B, N, S, D, sms) if fast else (B, N, S, D, H, sms)

    def call():
        err = fn(x["k"].data_ptr(), x["v"].data_ptr(), x["a"].data_ptr(), x["q"].data_ptr(),
                 x["g_av"].data_ptr(), x["g_af"].data_ptr(), gk.data_ptr(), gv.data_ptr(),
                 gq.data_ptr(), scratch.data_ptr(), *shape_args,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"backward at {shape}: CUDA error {err}")
        return gk, gv, gq
    return call


def check(label: str, what: str, shape, call, want) -> float:
    got = [t.clone() for t in call()]
    again = call()
    torch.cuda.synchronize()
    errs = [((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for g, w in zip(got, want)]
    same = all(torch.equal(g, y) for g, y in zip(got, again))
    ok = max(errs) <= chip_smoke.SWEEP_TOL and same
    print(f"  {label} {what} {list(shape)}: max_abs_err / max_abs {max(errs):.2e} "
          f"(tolerance {chip_smoke.SWEEP_TOL}), second launch bitwise equal: "
          f"{'yes' if same else 'NO'} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit(f"{label} {what} disagrees at {shape}")
    return max(errs)


def phase_report(label: str, what: str, shape, fns, call) -> dict:
    """Per phase, the cycles of a consumer warp a launch (lane 0's clock64,
    the mean over the warps of the blocks that ran) of 20 launches."""
    out = (ctypes.c_ulonglong * (2 * 256 * 8 * 8))()
    read = fns["dll"].heads_phases
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    call()
    torch.cuda.synchronize()
    read(ctypes.addressof(out))
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):
        raise SystemExit("heads_phases failed")
    k = 0 if what == "fwd" else 1
    cycles = torch.tensor(list(out), dtype=torch.float64).reshape(2, 256, 8, 8)[k]
    ran = cycles.sum((1, 2)) > 0
    per = (cycles[ran].mean((0, 1)) / 20)[:len(PHASES)]
    mhz = torch.cuda.get_device_properties(0).clock_rate / 1e3
    total = float(per.sum())
    print(f"    {label} {what} {list(shape)} phases (cycles of a consumer warp a launch, "
          f"{int(ran.sum())} blocks; {total / mhz:.1f} us at {mhz:.0f} MHz): "
          + ", ".join(f"{name} {c:.0f} ({100 * c / total:.1f} %)"
                      for name, c in zip(PHASES, per.tolist())), flush=True)
    return dict(zip(PHASES, per.tolist()))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _, bw, flops = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    sources = dict(arg.split("=", 1) for arg in sys.argv[1:] if arg != PHASES_FLAG) or {
        "change": str(ROOT / "ocrl_tpu_torch/ops/csrc/slot_routing.cu")}
    fns = {label: entries(lib) for label, lib in
           build({k: Path(v) for k, v in sources.items()}).items()}
    result = {"card": card, "shapes": []}
    cases = [("fwd", s) for s in chip_smoke.HEADS_SHAPES + SINGLE_FWD] + \
        [("bwd", s) for s in chip_smoke.HEADS_SHAPES + SINGLE_BWD]
    for i, (what, shape) in enumerate(cases):
        B, N, S, H, D = shape
        x = inputs(shape, seed=i)
        if what == "fwd":
            plain = lambda: tsr.route_sweep_reference(x["k"], x["v"], x["q"], H)  # noqa: E731
            bound_ms, bound_by = chip_smoke.sweep_bound_ms(B, N, S, D, bw, flops, H)
        else:
            leaves = [x[n].clone().requires_grad_() for n in ("k", "v", "q")]
            outs = tsr.route_sweep_reference(*leaves, H)
            plain = lambda: torch.autograd.grad(  # noqa: E731
                outs, leaves, (x["g_sa"], x["g_av"], x["g_a"]), retain_graph=True)
            bound_ms, bound_by = chip_smoke.sweep_bwd_bound_ms(B, N, S, D, bw, flops, H)
        want = [t.detach() for t in plain()]
        calls = {label: (forward_call if what == "fwd" else backward_call)(f, shape, x)
                 for label, f in fns.items()}
        errs = {label: check(label, what, shape, call, want) for label, call in calls.items()}
        if not tsr.fast_path(S, D, H):
            for label, f in fns.items():
                if tsr.HEADS_PLAN in f:
                    out = (ctypes.c_int * 14)()
                    f[tsr.HEADS_PLAN](S, D, H, ctypes.addressof(out))
                    plan = tsr.HeadsPlan(*out[:6] if what == "fwd" else out[6:12])
                    print(f"    {label} plan: {plan._asdict()}, {out[12 if what == 'fwd' else 13]}"
                          f" bytes of shared memory", flush=True)
        kernel = ("heads_" if not tsr.fast_path(S, D, H) else "sweep_") + what
        if label_phases := [lb for lb in calls if lb.endswith("-phases")]:
            if not tsr.fast_path(S, D, H):
                row_phases = {lb: phase_report(lb, what, shape, fns[lb], calls[lb])
                              for lb in label_phases}
            calls = {lb: c for lb, c in calls.items() if lb not in label_phases}
        times = {label: [] for label in calls}
        alone = {label: [] for label in calls}
        for r in range(ROUNDS):
            for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                ms, kernel_ms = chip_smoke.per_call_ms(calls[label], "", kernel, reps=REPS)
                times[label].append(ms)
                alone[label].append(kernel_ms)
        plain_ms = chip_smoke.per_call_ms(plain, reps=REPS)[0]
        row = dict(what=what, shape=list(shape), bound_ms=bound_ms, bound_by=bound_by,
                   plain_ms=plain_ms, sources={})
        for label, ms in times.items():
            med = statistics.median(ms)
            row["sources"][label] = dict(ms=ms, median=med, kernel_ms=alone[label],
                                         max_abs_err=errs[label])
            print(f"    {label} {what} {list(shape)}: device ms {min(ms):.4f}-{max(ms):.4f} "
                  f"(median {med:.4f}; {100 * bound_ms / med:.1f} % of the bound "
                  f"{bound_ms:.4f}, {bound_by}; {kernel} alone "
                  f"{statistics.median(alone[label]):.4f}); plain {plain_ms:.4f}", flush=True)
        result["shapes"].append(row)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
