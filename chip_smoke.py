#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

  1. env        the card (nvidia-smi name and power limit, also printed raw),
                torch/CUDA versions, which optional packages import;
  2. build      the kernel csbsr_tpu_torch/csrc/minplus.cu, with nvcc, into
                build/;
  3. kernels    each kernel against its plain PyTorch version on the card at
                the shapes of the main path (min-plus: torch.equal), plus the
                EDT against a brute-force distance on a small mask; kernel
                and plain-version times with CUDA events;
  4. main path  the flagship recipe (config/flagship.py: KBPN 4 stages x4,
                md 128, kernel 7 -> 21, PSPNet-ResNet34, IMAGE_SIZE 224, bf16
                compute) with random weights from a seed, scoring 8
                synthetic 448x448 crack images made on the card
                (data/synthetic.py; AIU + the device HD/MSD bank) through
                engine/inference.score_for_ss; kernel launch counts are reset
                just before and read just after; then the HD bank of one image
                again with the plain row pass, which must agree exactly, and
                the model in float32 on the card against the same weights on
                the host CPU on one patch (relative error <= 1e-3).

Then the `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
It exits without a result when CUDA is absent or the package is missing.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
HR_SIZE = 448
SEED = 1121
MEM_BW = 3.35e12  # H100 SXM device memory, bytes/s (NVIDIA data sheet)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """First line of `nvidia-smi --query-gpu=<query> --format=<fmt>`."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_env():
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    optional = {}
    for mod in ("yaml", "PIL", "pandas", "matplotlib", "scipy"):
        try:
            __import__(mod)
            optional[mod] = True
        except ImportError:
            optional[mod] = False
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "optional_imports": optional})
    return card


def phase_build():
    from csbsr_tpu_torch.ops import cuda_build, minplus

    t0 = time.perf_counter()
    cuda_build.load(minplus._NAME, "csbsr_minplus_rows", minplus._ARGTYPES)
    emit({"phase": "build", "kernels": [minplus._NAME], "seconds": time.perf_counter() - t0,
          "ptxas": {k: [l for l in v.splitlines() if "registers" in l or "smem" in l]
                    for k, v in cuda_build.BUILD_REPORTS.items()}})


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over `reps` single calls, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _brute_edt(mask):
    """Distance to the nearest True pixel by exhaustive search (numpy)."""
    import numpy as np

    pts = np.argwhere(mask)
    yy, xx = np.mgrid[: mask.shape[0], : mask.shape[1]]
    d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    return np.sqrt(d2.min(-1))


def phase_kernels(dev):
    from csbsr_tpu_torch.ops.edt import _column_distance, edt
    from csbsr_tpu_torch.ops.minplus import minplus_rows, minplus_rows_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(2, 1, 33, 47), (3, 128, 128), (2, 33, 2100), (1, 40, 50), (99, 449, 449)]
    checks, max_err = [], 0.0
    for shape in shapes:
        if shape == (1, 40, 50):  # an all-False slice: the 1e9 cap
            mask = torch.zeros(shape, dtype=torch.bool, device=dev)
        else:
            mask = torch.rand(shape, generator=gen, device=dev) < 0.02
        g = _column_distance(mask).contiguous()
        out, ref = minplus_rows(g), minplus_rows_reference(g)
        torch.cuda.synchronize()
        equal = torch.equal(out, ref)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        checks.append({"shape": list(shape), "equal": equal, "max_abs_err": err})
        if not equal:
            raise AssertionError(f"minplus kernel != plain version at {shape}: {err}")

    small = (torch.rand((61, 77), generator=gen, device=dev) < 0.03)
    small[5, 7] = True
    d = edt(small).cpu().numpy()
    ref = _brute_edt(small.cpu().numpy())
    edt_err = float(abs(d - ref).max())
    if edt_err > 1e-5:
        raise AssertionError(f"EDT disagrees with brute force: {edt_err}")

    # timing at the HD-bank shape of one 448x448 image: (99, 449, 449)
    g = _column_distance(torch.rand((99, 449, 449), generator=gen, device=dev) < 0.02)
    g = g.contiguous()
    ms = _time_ms(lambda: minplus_rows(g), reps=25, warmup=3)
    plain_ms = _time_ms(lambda: minplus_rows_reference(g), reps=5, warmup=1)
    rows, w = g.numel() // g.shape[-1], g.shape[-1]
    props = torch.cuda.get_device_properties(dev)
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    # one fused multiply-add and one min per candidate (r, j, k), issued on
    # 128 FP32 lanes per SM per clock
    ops = 2.0 * rows * w * w
    ops_ms = ops / (props.multi_processor_count * 128 * clock_hz) * 1e3
    bytes_ms = 2.0 * g.numel() * 4 / MEM_BW * 1e3  # g read once, out written once
    entry = {
        "name": "minplus_rows", "route": "cuda", "source": "csbsr_tpu_torch/csrc/minplus.cu",
        "replaces": "csbsr_tpu/ops/pallas/minplus.py:68", "launches": None,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
    }
    emit({"phase": "kernels", "minplus_checks": checks, "edt_vs_bruteforce_max_err": edt_err,
          "timing_shape": list(g.shape), "candidates": rows * w * w,
          "sm_count": props.multi_processor_count, "sm_clock_max_hz": clock_hz,
          "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms, "minplus": entry})
    return [entry]


def phase_main_path(dev):
    from csbsr_tpu_torch.config.flagship import flagship_cfg
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import score_for_ss, thresholds_for
    from csbsr_tpu_torch.metrics.device_surface import distance_metrics_banked
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build
    from csbsr_tpu_torch.ops.minplus import minplus_rows_reference

    cfg = flagship_cfg(SEED)
    t0 = time.perf_counter()
    model = model_from_cfg(cfg, device=dev)
    build_s = time.perf_counter() - t0
    data = SyntheticCrackSet(cfg, N_IMAGES, HR_SIZE, dev, seed=SEED)
    torch.cuda.synchronize()
    kept = {}

    def keep_first(fname, sr_pred, seg_pred, k2d):
        if not kept:
            kept.update(sr=sr_pred, seg=seg_pred, k2d=k2d)

    cuda_build.LAUNCHES.clear()
    rows, summary, _ = score_for_ss(cfg, model, data, device=dev, test_aiu=True,
                                    test_surface_distance=True, on_image=keep_first,
                                    log_fn=lambda *a: None)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)

    if launches.get("minplus_rows", 0) != 2 * N_IMAGES:
        raise AssertionError(f"expected {2 * N_IMAGES} minplus launches, got {launches}")
    bad = {k: v for k, v in summary.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    if tuple(kept["sr"].shape) != (1, 3, HR_SIZE, HR_SIZE) or \
            tuple(kept["seg"].shape) != (1, 1, HR_SIZE, HR_SIZE):
        raise AssertionError(f"unexpected output shapes {kept['sr'].shape} {kept['seg'].shape}")

    # the same HD bank, kernel vs plain row pass, on image 0
    seg_t = data.get(0)[2][None]
    th = torch.as_tensor(thresholds_for(True), device=dev)
    prob, gt = kept["seg"][:, 0], (seg_t[:, 0] > 0.5).float()
    pad = (0, -(-HR_SIZE // 64) * 64 - HR_SIZE, 0, -(-HR_SIZE // 64) * 64 - HR_SIZE)
    prob, gt = torch.nn.functional.pad(prob, pad), torch.nn.functional.pad(gt, pad)
    hd_k, msd_k = distance_metrics_banked(prob, gt, th, max_len=HR_SIZE)
    hd_p, msd_p = distance_metrics_banked(prob, gt, th, max_len=HR_SIZE,
                                          row_pass=minplus_rows_reference)
    if not (torch.equal(hd_k, hd_p) and torch.equal(msd_k, msd_p)):
        raise AssertionError("HD/MSD differ between the kernel and the plain row pass")

    ref = check_against_cpu(model, cfg, data.get(0)[0][:1])
    secs = [r["seconds"] for r in rows]
    emit({"phase": "main_path", "config": "configs/config_csbsr_pspnet.yaml (random init, "
          f"seed {SEED}, bf16 compute)", "images": N_IMAGES, "image_hw": [HR_SIZE, HR_SIZE],
          "patches_per_image": int(data.get(0)[0].shape[0]),
          "lr_patch_hw": list(data.get(0)[0].shape[-2:]),
          "params": sum(p.numel() for p in model.parameters()),
          "model_build_s": build_s, "summary": summary,
          "first_image_s": secs[0], "images_per_s_after_warmup": (len(secs) - 1) / sum(secs[1:]),
          "per_image_s": secs, "launches": launches,
          "hd_plain_row_pass_equal": True, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "float32_vs_cpu": ref})
    return launches


def check_against_cpu(model, cfg, patch):
    """The full-width model on the card in float32 (no TF32) against the same
    weights on the host CPU, on one LR patch. The CPU path is the one the
    tests hold to the JAX package; the two differ only in summation order.
    Also reports how far the compute-dtype (bf16) run is from float32 (not a
    check)."""
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils.device import full_fp32

    cpu_model = model_from_cfg(cfg, device="cpu", dtype=torch.float32, seed=SEED)
    compute = model.dtype
    with torch.inference_mode(), full_fp32():
        low = model(patch, clip_sr=True)
        model.dtype = torch.float32
        try:
            gpu = model(patch, clip_sr=True)
        finally:
            model.dtype = compute
        cpu = cpu_model(patch.cpu(), clip_sr=True)
    keys = ("sr", "seg", "kernel")
    # max |difference| relative to max |CPU value|, per output
    err = {k: float((gpu[k].cpu() - cpu[k]).abs().max() / cpu[k].abs().max()) for k in keys}
    if max(err.values()) > 1e-3:
        raise AssertionError(f"CUDA float32 model disagrees with the CPU: {err} (tolerance 1e-3)")
    low_err = {k: float((low[k].float() - gpu[k]).abs().max() / gpu[k].abs().max()) for k in keys}
    return {"max_rel_err": err, "tolerance": 1e-3, "compute_dtype_vs_float32_max_rel": low_err}


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        return 2
    sys.path.insert(0, REPO)
    import csbsr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_env()
    phase_build()
    kernels = phase_kernels(dev)
    launches = phase_main_path(dev)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
