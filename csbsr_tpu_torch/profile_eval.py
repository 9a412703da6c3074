"""Where the time of the port's evaluation goes, on the card.

    python -m csbsr_tpu_torch.profile_eval

Scores the flagship recipe (config/flagship.py, random weights from a seed)
on synthetic 448x448 crack sets made on the card (data/synthetic.py), the
same work as chip_smoke.py's main path: two images to warm up, then eight
in one pass under torch.profiler (CPU + CUDA activity). Prints one JSON
line: the card, host seconds per image, device time per image for each
named range of engine/inference.score_for_ss (eval.model, eval.sr_metrics,
eval.iou, eval.hd_bank), device time by kernel class and the top kernels,
and the device's busy and idle shares of the profiled wall time.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

IMAGES = 8
SIZE = 448
SEED = 1121
RANGES = ("eval.model", "eval.sr_metrics", "eval.iou", "eval.hd_bank")
# kernel-name fragments -> class, first match wins
CLASSES = (
    ("minplus", ("minplus",)),
    ("conv/gemm", ("conv", "gemm", "xmma", "cutlass", "cudnn", "sm90", "implicit", "winograd")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill")),
    ("resize/pool", ("upsample", "pool", "interp")),
)


def _class_of(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def main():
    from .config.flagship import flagship_cfg
    from .data.synthetic import SyntheticCrackSet
    from .engine.inference import score_for_ss
    from .models import model_from_cfg
    from .utils.device import resolve_device

    dev = resolve_device("cuda")
    cfg = flagship_cfg(SEED)
    model = model_from_cfg(cfg, device=dev)
    kw = dict(device=dev, test_aiu=True, test_surface_distance=True, log_fn=lambda *a: None)
    score_for_ss(cfg, model, SyntheticCrackSet(cfg, 2, SIZE, dev, seed=SEED + 1), **kw)
    data = SyntheticCrackSet(cfg, IMAGES, SIZE, dev, seed=SEED)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows, _, _ = score_for_ss(cfg, model, data, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({
        "images": IMAGES, "image_hw": [SIZE, SIZE],
        "wall_s_per_image": wall / IMAGES, "images_per_s": IMAGES / wall,
        "host_s_per_image_rows": [r["seconds"] for r in rows],
        **summarize(prof, RANGES, IMAGES, wall, "image"),
    }))


def summarize(prof, ranges, n, wall, unit):
    """The card, the device time per `unit` (n of them in `wall` seconds) in
    each named range and by kernel class, the top kernels and the device's
    busy and idle shares of the wall time."""
    per = {r: {"device_ms": 0.0, "host_ms": 0.0} for r in ranges}
    for evt in prof.events():
        if evt.name in per and evt.device_type == DeviceType.CPU:
            per[evt.name]["device_ms"] += evt.device_time_total / 1e3 / n
            per[evt.name]["host_ms"] += evt.cpu_time_total / 1e3 / n

    kernels, classes, total_us = [], {}, 0.0
    for evt in prof.key_averages():
        us = float(evt.self_device_time_total)
        if us <= 0 or evt.device_type != DeviceType.CUDA or evt.key in per:
            continue  # host ops and the ranges' device-side spans: their kernels count
        total_us += us
        cls = _class_of(evt.key)
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / n
        kernels.append((us, evt.key, evt.count))
    kernels.sort(reverse=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    busy = total_us / 1e6 / wall
    return {
        "card": card, f"device_ms_per_{unit}": total_us / 1e3 / n,
        "device_busy_share": busy, "device_idle_share": 1.0 - busy,
        f"ranges_per_{unit}": per,
        f"kernel_classes_ms_per_{unit}": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": k[:120], f"ms_per_{unit}": us / 1e3 / n,
                         f"calls_per_{unit}": c / n} for us, k, c in kernels[:15]],
    }

if __name__ == "__main__":
    main()
