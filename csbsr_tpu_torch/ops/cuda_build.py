"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc` for sm_90a into a shared library under `build/` at the repository
root (git-ignored), named after a hash of its source so an edit rebuilds it;
`build` starts one `nvcc` per source, all together.
The library is loaded with ctypes. Nothing here runs at import: the CPU
tests import every module, and a CPU-only machine has no `nvcc`.

`LAUNCHES` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
# name -> the compiler's report (ptxas registers / shared memory) of a build
# made by this process
BUILD_REPORTS: dict = {}

_fns: dict = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(*names) -> None:
    """Build the libraries of `names` that are not current, one `nvcc` per
    source, all started together."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    todo = [(name, library_path(name)) for name in names]
    todo = [(name, out) for name, out in todo if not out.is_file()]
    if not todo:
        return
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {out.name}:\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        BUILD_REPORTS[name] = (stdout + stderr).strip()
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `symbol` of `csrc/<name>.cu`, which returns a cudaError_t;
    the library is built first if it is not current."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            build(name)
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _fns[(name, symbol)] = fn
        return fn


def check_launch(name: str, err: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
