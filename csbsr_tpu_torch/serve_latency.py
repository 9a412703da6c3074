"""Serving latency of the flagship on the card, in bf16 and in int8.

    python -m csbsr_tpu_torch.serve_latency [--iters 30]

The port of `tools/serve_latency.py`, in three regimes, each in the
model's compute dtype (bf16) and then with int8 convs calibrated on a batch
of the same patches (engine/inference.calibrate_int8):

  1. latency: B in {1, 4, 8} LR patches of 56 x 56 -> 224 x 224 SR and seg,
     ms per call;
  2. full image, host-inclusive: one 448 x 448 and one 896 x 896 HR image
     (112^2 / 224^2 LR on the host: 4 / 16 patches): upload, split_patch,
     one model call, joint_patch on the card, the copy of SR and seg to the
     host as float32 or (u8) the SR as uint8, ms per image;
  3. convs: one of each int8 conv shape of a 12-patch 56^2 call (the test
     CLI's default chunk), the bf16 cuDNN conv against the int8 conv
     (quantize, im2col, torch._int_mm, dequant) and its int8 product alone,
     beside the bound of the work (int8 operations at the H100's dense int8
     rate, bf16 ones at its bf16 rate, bytes of the bf16 input, weight and
     output at its memory rate).

Every time is the median of `iters` calls, each synchronised by reading a
value of its result back to the host (a real serving call ends so); the
inputs are the same in every call (CUDA does not deduplicate executions).
Prints one JSON line per regime and mode, with the card's name and power
limit and the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 56
BATCHES = (1, 4, 8)
HR_SIZES = (448, 896)
CONV_BATCH = 12
SEED = 1121
# H100 SXM data sheet, dense: int8 1979 TOP/s, bf16 989 TFLOP/s, HBM3 3.35 TB/s
PEAK_INT8_OPS, PEAK_BF16_FLOPS, PEAK_BYTES = 1979e12, 989e12, 3.35e12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _median_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def latency(model, dev, iters: int):
    """Regime 1: ms per call at each B, synchronised by a value read back."""
    rng = np.random.RandomState(SEED)
    out = {}
    for b in BATCHES:
        x = torch.from_numpy(rng.rand(b, 3, PATCH, PATCH).astype(np.float32)).to(dev)

        def call():
            with torch.inference_mode():
                o = model(x, clip_sr=True)
            float(o["seg"][-1, 0, -1, -1])  # the read-back ends the call

        ms = _median_ms(call, iters)
        out[f"latency_b{b}_ms"] = ms
        out[f"latency_b{b}_ms_per_image"] = ms / b
    return out


def full_image(model, cfg, dev, hr_size: int, u8: bool, iters: int) -> float:
    """Regime 2: ms for one HR image, host numpy in, host numpy out."""
    from .engine.inference import build_infer_fn, sr_to_uint8
    from .ops.patch import joint_patch, split_patch

    sf = int(cfg.MODEL.SCALE_FACTOR)
    lr = np.random.RandomState(hr_size).rand(3, hr_size // sf, hr_size // sf).astype(np.float32)
    infer = build_infer_fn(cfg, model, dev)

    def call():
        x = torch.from_numpy(lr).to(dev)
        patches, ushape = split_patch(x, PATCH, PATCH)
        ushape[[5, 6]] *= sf
        seg_ushape = ushape.copy()
        seg_ushape[4] = 1
        sr_p, seg_p, _ = infer(patches.contiguous())
        sr = joint_patch(sr_p, ushape)
        sr = (sr_to_uint8(sr) if u8 else sr).cpu().numpy()
        seg = joint_patch(seg_p, seg_ushape).cpu().numpy()
        assert sr.shape == (1, 3, hr_size, hr_size) and seg.shape == (1, 1, hr_size, hr_size)

    return _median_ms(call, max(10, iters // 3))


def run_mode(model, cfg, dev, iters: int):
    """Regimes 1 and 2 on `model` as it is; with peak memory."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = latency(model, dev, iters)
    for hr in HR_SIZES:
        for u8 in (False, True):
            out[f"full_image_{hr}{'_u8' if u8 else ''}_ms"] = full_image(model, cfg, dev, hr, u8,
                                                                        iters)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def conv_shapes(model, x):
    """{config key: [module name, module, input shape, calls]} of the int8
    convs that one call on `x` runs, keyed by (kind, k, stride, padding,
    dilation, groups, Cin, Cout, H, W), the first module of each."""
    from .models.blocks import Int8ConvTranspose2d, int8_modules

    seen, hooks = {}, []
    for name, mod in int8_modules(model):
        def hook(m, inp, _out, name=name):
            kind = "deconv" if isinstance(m, Int8ConvTranspose2d) else "conv"
            shape = tuple(inp[0].shape)
            key = (kind, m.kernel_size[0], m.stride[0], m.padding[0], m.dilation[0], m.groups,
                   shape[1], m.out_channels, shape[2], shape[3])
            seen.setdefault(key, [name, m, shape, 0])[3] += 1
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(x, clip_sr=True)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _macs(kind, k, cin_g, cout, out_hw, in_hw, n):
    """Multiply-adds of the conv (for a transposed conv, per input pixel)."""
    if kind == "deconv":
        return n * in_hw[0] * in_hw[1] * cin_g * cout * k * k
    return n * out_hw[0] * out_hw[1] * cin_g * cout * k * k


def conv_table(model, dev, iters: int):
    """Regime 3: bf16 conv vs int8 conv per shape of a CONV_BATCH-patch call."""
    from .ops.quant import conv_acc, conv_transpose_acc, quantize_act, quantize_weight

    x = torch.from_numpy(np.random.RandomState(SEED).rand(CONV_BATCH, 3, PATCH, PATCH)
                         .astype(np.float32)).to(dev)
    rows = []
    for key, (name, m, shape, calls) in conv_shapes(model, x).items():
        kind, k, s, p, _, g, cin, cout, h, w = key
        qc = m.quant_channels
        cin_q = cin if qc is None else qc
        xin = torch.randn((shape[0], cin_q, h, w), device=dev, dtype=torch.bfloat16)
        wt = m.weight if qc is None else m.weight[:, :qc]
        wb = wt.detach().to(torch.bfloat16)
        if kind == "deconv":
            bf16 = lambda: F.conv_transpose2d(xin, wb, None, m.stride, m.padding)
            xq, _ = quantize_act(xin, m.act_amax)
            wq, _ = quantize_weight(wt, out_axis=1)
            product = lambda: conv_transpose_acc(xq, wq, m.stride, m.padding)
        else:
            bf16 = lambda: F.conv2d(xin, wb, None, m.stride, m.padding, m.dilation, g)
            xq, _ = quantize_act(xin, m.act_amax)
            wq, _ = quantize_weight(wt, out_axis=0)
            product = lambda: conv_acc(xq, wq, m.stride, m.padding, m.dilation, g)
        y = bf16()
        macs = _macs(kind, k, cin_q // g, cout, y.shape[-2:], (h, w), shape[0])
        nbytes = 2 * (xin.numel() + wb.numel() + y.numel())
        times = {}
        for label, fn in (("bf16_ms", bf16), ("int8_ms", lambda: m._int8(xin, wt)),
                          ("int8_product_ms", product)):
            times[label] = _device_ms(fn, iters)
        bound_int8 = max(2 * macs / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        bound_bf16 = max(2 * macs / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        rows.append({"module": name, "calls": calls, "kind": kind, "k": k, "stride": s,
                     "padding": p, "groups": g, "cin": cin_q, "cout": cout, "in_hw": [h, w],
                     "out_hw": list(y.shape[-2:]), "batch": shape[0], "gmacs": macs / 1e9,
                     "bytes": nbytes, **times, "int8_bound_ms": bound_int8,
                     "int8_bound_by": "operations" if 2 * macs / PEAK_INT8_OPS >
                     nbytes / PEAK_BYTES else "bytes",
                     "bf16_bound_ms": bound_bf16})
    return rows


def _device_ms(fn, iters: int) -> float:
    """CUDA-event ms per call over `iters` back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_latency measures the card: CUDA is not available")
    from .config.flagship import flagship_cfg
    from .engine.inference import calibrate_int8
    from .models import model_from_cfg

    dev = torch.device("cuda", 0)
    cfg = flagship_cfg(SEED)
    model = model_from_cfg(cfg, device=dev)
    head = {"card": card(), "config": f"configs/config_csbsr_pspnet.yaml, random init, seed {SEED}"}
    print(json.dumps({**head, "regime": "latency+full_image", "mode": "bf16",
                      **run_mode(model, cfg, dev, args.iters)}))
    calib = np.random.RandomState(SEED).rand(8, 3, PATCH, PATCH).astype(np.float32)
    calibrate_int8(model, calib)
    print(json.dumps({**head, "regime": "latency+full_image", "mode": "int8",
                      **run_mode(model, cfg, dev, args.iters)}))
    print(json.dumps({**head, "regime": "convs", "rows": conv_table(model, dev, args.iters)}))

if __name__ == "__main__":
    main()
