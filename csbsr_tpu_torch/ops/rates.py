"""Measured dispatch rates of the card, and the min-plus kernel's bound from them.

`measure` times each microkernel of `csrc/rates.cu` at full occupancy and
returns how many of its operation one SM completes per clock (at the card's
maximum SM clock). `minplus_bound` is then the least time the card could
take for a min-plus row pass: the larger of the bytes it must move and its
candidates at the best rate any mix of the exact routes (`ROUTES`) reaches
under the dispatch rate (4 schedulers x 32 lanes = 128 thread-instructions
per SM per clock) and the measured rate of each pipe (`PIPES`), a linear
program over the routes (`candidate_rate`).
"""
from __future__ import annotations

import collections
import ctypes
import itertools
import math
import re
import shutil
import statistics
import subprocess

import numpy as np
import torch

from . import cuda_build

__all__ = ["OPS", "ROUTES", "PIPES", "DISPATCH_RATE", "MEM_BW", "measure", "route_cost",
           "candidate_rate", "minplus_bound", "sass_opcodes"]

_NAME = "rates"
OPS = {"fmnmx": 0, "fadd": 1, "ffma": 2, "pair": 3, "viaddmin": 4, "vimin3": 5, "pair3": 6,
       "minmix": 7}
DISPATCH_RATE = 128  # thread-instructions per SM per clock: 4 schedulers x 32 lanes
MEM_BW = 3.35e12  # H100 SXM device memory, bytes/s (NVIDIA data sheet)
# instructions per candidate min(G + (j - k)^2, acc) of each exact route
# ("dpx" adds in int32: exact for the integer-valued column distances every
# caller feeds); "pair" and "pair3" measure the float and vimin3 mixes whole
ROUTES = {
    "float": {"fadd": 1.0, "fmnmx": 1.0},  # FADD + FMNMX
    "dpx": {"viaddmin": 1.0},  # VIADDMNMX in int32
    "vimin3": {"fadd": 1.0, "vimin3": 0.5},  # two FADDs + one VIMNMX3 per two candidates
}
# the instructions that share one pipe; "minmix" (FMNMX, VIADDMNMX and
# VIMNMX3 interleaved) runs no faster than each alone, which shows the three
# share theirs
PIPES = {"min": ("fmnmx", "viaddmin", "vimin3"), "fadd": ("fadd",)}
_BLOCKS_PER_SM = 8  # of 256 threads: 2048 threads, the SM's maximum
_ITERS = 1000


def measure(device: torch.device, clock_hz: float, reps: int = 5) -> dict:
    """{op: operations per SM per clock} for every op of OPS, each the median
    of `reps` timed launches (CUDA events) after one warm-up launch."""
    fn = cuda_build.load(_NAME, "csbsr_rate", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    per_trip = cuda_build.load(_NAME, "csbsr_rate_ops_per_trip", [ctypes.c_int])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * _BLOCKS_PER_SM
    sink = torch.zeros(blocks * 256, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rates = {}
    for name, op in OPS.items():
        ops_per_launch = blocks * 256 * _ITERS * per_trip(op)
        times = []
        for i in range(reps + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            cuda_build.check_launch(f"rate_{name}", fn(op, blocks, _ITERS, 3 + i, sink.data_ptr(),
                                                       stream))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        rates[name] = ops_per_launch / (statistics.median(times[1:]) * clock_hz * sms)
    return rates


def route_cost(route: str, rates: dict) -> float:
    """SM-clocks per candidate of `route` alone: the larger of its dispatch
    time and the time of each of its instructions at its measured rate."""
    mix = ROUTES[route]
    return max(sum(mix.values()) / DISPATCH_RATE, *(n / rates[op] for op, n in mix.items()))


def candidate_rate(rates: dict):
    """(candidates per SM per clock, {route: its candidates per SM per clock})
    of the best mix of ROUTES: maximise the candidates x_r of each route
    subject to the dispatch rate (sum_r x_r * instructions_r <= 128) and to
    each pipe of PIPES (sum_r x_r * sum_{op in pipe} n_op / rate_op <= 1),
    x >= 0. Solved at the vertices: every choice of as many active
    constraints as routes."""
    routes = list(ROUTES)
    rows = [[sum(ROUTES[r].values()) for r in routes]]
    caps = [float(DISPATCH_RATE)]
    for ops in PIPES.values():
        rows.append([sum(n / rates[op] for op, n in ROUTES[r].items() if op in ops)
                     for r in routes])
        caps.append(1.0)
    a = np.vstack([np.array(rows), -np.eye(len(routes))])
    b = np.array(caps + [0.0] * len(routes))
    best, mix = 0.0, None
    for active in itertools.combinations(range(len(b)), len(routes)):
        try:
            x = np.linalg.solve(a[list(active)], b[list(active)])
        except np.linalg.LinAlgError:
            continue
        if (a @ x <= b + 1e-9 * np.abs(b).clip(1.0)).all() and x.sum() > best:
            best, mix = float(x.sum()), x
    return best, {r: float(v) for r, v in zip(routes, mix)}


def minplus_bound(shape, rates: dict, sms: int, clock_hz: float) -> dict:
    """The least time of the row pass on `shape` (..., W): the larger of the
    operations bound (rows * W * W candidates at `candidate_rate` on `sms`
    SMs at `clock_hz`) and the bytes bound (g read once, out written once,
    at MEM_BW); beside them the bound of VIMNMX3 alone, the kernel's route,
    and the old rule of two FP32 instructions per candidate at 128 per SM
    per clock."""
    rows, w = math.prod(shape[:-1]), shape[-1]
    candidates = rows * w * w
    per_clock, mix = candidate_rate(rates)
    ops_ms = candidates / (per_clock * sms * clock_hz) * 1e3
    bytes_ms = 2.0 * rows * w * 4 / MEM_BW * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "candidates_per_sm_per_clock": per_clock, "bound_mix": mix,
            "vimin3_alone_ms": candidates * route_cost("vimin3", rates) / (sms * clock_hz) * 1e3,
            "two_fp32_per_candidate_ms": 2.0 * candidates / (sms * 128 * clock_hz) * 1e3,
            "candidates": candidates}


def sass_opcodes(name: str) -> dict:
    """{kernel symbol: Counter of SASS opcodes} of the built library of
    `csrc/<name>.cu`, from `cuobjdump -sass`; empty where the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn is not None:
            out[fn][m.group(1).split(".")[0]] += 1
    return out
