"""Build the port's CUDA sources and launch their kernels.

Each ``csrc/<name>.cu`` exports plain C functions. At first use it is
compiled by ``nvcc`` into ``build/ocrl_tpu_torch/lib<name>-<hash>.so`` at the
root of the checkout, keyed by a hash of the sources and the flags, and
loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds. Every pointer and the stream are passed as ``c_void_p``; every C
entry point returns the launch's ``cudaGetLastError()``, which ``launch``
turns into an exception.

``LAUNCHES`` counts, per kernel name, the launches made through ``launch``
and nowhere else; ``chip_smoke.py`` resets and reads it around the main path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ocrl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $CUDA_PATH or $PATH, else the toolkit's default
    install prefix; raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one nvcc per source, all started together. Returns the
    seconds of each source compiled now."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds = {}
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
        seconds[name] = time.perf_counter() - t0
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, function: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``function`` of ``csrc/<name>.cu``, typed: every
    entry point returns its launch's CUDA error code as an int."""
    fn = getattr(library(name), function)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, fn, *args) -> None:
    """Call a C entry point, raise on its CUDA error code, count the launch."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def launch_on(device: torch.device, kernel: str, fn, *args) -> None:
    """``launch`` on ``device``'s current stream, passed as the last
    argument."""
    with torch.cuda.device(device):
        launch(kernel, fn, *args, torch.cuda.current_stream(device).cuda_stream)


def reset_launches() -> None:
    LAUNCHES.clear()
