"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc` for sm_90a into a shared library under `build/` at the repository
root (git-ignored), named after a hash of its source so an edit rebuilds it.
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


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `symbol` of `csrc/<name>.cu`, which returns a cudaError_t;
    the library is built first if it is not current."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            out = library_path(name)
            if not out.is_file():
                nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                if not os.path.isfile(nvcc):
                    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stderr}{proc.stdout}")
                os.replace(tmp, out)
                BUILD_REPORTS[name] = (proc.stdout + proc.stderr).strip()
            fn = getattr(ctypes.CDLL(str(out)), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _fns[(name, symbol)] = fn
        return fn


def check_launch(name: str, err: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
