"""Device time of the min-plus row pass at the shapes of the port's main paths.

    python -m csbsr_tpu_torch.bench_minplus

Shapes: (99, 449, 449), the HD bank of one 448x448 image
(metrics/device_surface.py); (1, 449, 449), its GT border; (6, 1, 224, 224),
the training SDF of one step (ops/edt.sdf_normalized). The input of each is
the column pass of a random mask (2% True) made from a seed on the card.
For each: `minplus_rows` checked equal (torch.equal) to the plain version,
its device time (`device_ms`) and the kernel's own duration in a profiler
trace (`trace_ms`). Prints the card's name and power limit, then one JSON
line per shape.

From the port it uses only `ops.minplus.minplus_rows`,
`ops.minplus.minplus_rows_reference` and `ops.edt._column_distance`, which
every version of the port has, so the file also times the kernel of another
checkout of the repository, for a before/after comparison on one card:

    PYTHONPATH=<other checkout> python csbsr_tpu_torch/bench_minplus.py

`chip_smoke.py` times its kernels with `device_ms` and `trace_ms` too.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

SHAPES = ((99, 449, 449), (1, 449, 449), (6, 1, 224, 224))
SEED = 1121
REPS = 50
SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's SM clock


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time of one call: the median over `reps` calls, each bracketed
    by CUDA events. Before each, the stream sleeps on the card
    (torch.cuda._sleep) while the host queues the call, so the time is that
    of the device work and not of the host's launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace_ms(fn, reps: int):
    """Mean duration of the device kernels whose name holds "minplus" over
    `reps` calls of `fn`, from a torch.profiler (CUPTI) trace; None where
    the trace lacks some of them (CUPTI may drop a trace's records)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for event in prof.key_averages():
        if "minplus" in event.key:
            total += getattr(event, "device_time_total", 0.0)
            count += event.count
    return total / count / 1e3 if count == reps else None


def main():
    from csbsr_tpu_torch.ops.edt import _column_distance
    from csbsr_tpu_torch.ops.minplus import minplus_rows, minplus_rows_reference

    if not torch.cuda.is_available():
        raise SystemExit("bench_minplus: CUDA is not available")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    equal = True
    for shape in SHAPES:
        g = _column_distance(torch.rand(shape, generator=gen, device=dev) < 0.02).contiguous()
        same = torch.equal(minplus_rows(g), minplus_rows_reference(g))
        equal &= same
        print(json.dumps({"shape": list(shape), "equal": same,
                          "ms": device_ms(lambda: minplus_rows(g), REPS),
                          "trace_ms": trace_ms(lambda: minplus_rows(g), REPS)}), flush=True)
    if not equal:
        raise SystemExit("the kernel disagrees with the plain version")


if __name__ == "__main__":
    main()
