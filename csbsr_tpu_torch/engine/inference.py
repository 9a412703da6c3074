"""Test-time inference (`csbsr_tpu/engine/inference.py`).

Patched LR -> model -> patch reassembly -> PSNR/SSIM/kernel-PSNR, IoU at 99
thresholds (AIU) and, optionally, HD/MSD over the same 99-threshold bank on
the device (metrics/device_surface.py, whose EDT row pass is the CUDA
min-plus kernel on the card) or with the host oracle
(metrics/surface_distance.py), and Acc/Sens/Spec at threshold 0.5 (the
retinal metrics).

`inference_tti` serves unlabelled images: the patch chunks' outputs stay on
the device, are joined there, and cross to the host once per image, the SR
as uint8 (the bytes its PNG holds) and the seg map as float32.
`calibrate_int8` switches a model to int8 serving with calibrated scales.

Each image's work runs in named profiler ranges (eval.model, eval.sr_metrics,
eval.iou, eval.hd_bank) that `python -m csbsr_tpu_torch.profile_eval` reads;
outside a profiler they cost a few microseconds per image.

Split in two so the scoring runs without pandas, matplotlib or PIL:
  - `score_for_ss` returns the per-image rows, the summary and the
    per-threshold curves;
  - `write_artifacts` writes metrics.jsonl, iou_log.csv and the curve pngs;
  - `inference_for_ss` does both, plus the image dumps of `save_images`.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..metrics.device_metrics import iou_thresholds, psnr, ssim
from ..metrics.device_surface import distance_metrics_banked
from ..models.blocks import int8_modules, int8_serve
from ..ops.patch import joint_patch
from ..utils.device import full_fp32, resolve_device

# the masks saved of the 99-threshold bank: 0.01, 0.10, 0.20, ..., 0.90, 0.99
SAVE_IDX = [0] + [9 + i * 10 for i in range(9)] + [98]
CLS_THRESHOLD = 0.5  # the retinal metrics' threshold


def _prefetched(dataset):
    """Yield dataset.get(i) in order, loading two items ahead on one
    background thread so host decode and patching overlap the device."""
    from concurrent.futures import ThreadPoolExecutor

    n, depth = len(dataset), 2
    with ThreadPoolExecutor(max_workers=1) as pool:
        futs = [pool.submit(dataset.get, i) for i in range(min(depth, n))]
        for i in range(n):
            item = futs.pop(0).result()
            if i + depth < n:
                futs.append(pool.submit(dataset.get, i + depth))
            yield item


def build_infer_fn(cfg, model, device):
    """Patched forward: patches (N, 3, h, w) -> (sr, seg, kernel_2d), float32.
    Eval BN has no batch dependence, so any patch count runs as it is. At
    SCALE_FACTOR 1 the patches are the HR image (the test sets read no LR
    then), so they are also the SR output; the JAX harness passes no SR
    target there and fails."""
    ksize_out = int(cfg.BLUR.KERNEL_SIZE_OUTPUT)
    same_size = cfg.MODEL.SCALE_FACTOR == 1

    @torch.inference_mode()
    def infer(patches):
        x = torch.as_tensor(patches, dtype=torch.float32, device=device)
        out = model(x, clip_sr=True, sr_targets=x if same_size else None)
        kvec = out["kernel"].float()
        kvec = kvec / kvec.sum(dim=-1, keepdim=True)
        return out["sr"].float(), out["seg"].float(), kvec.reshape(-1, ksize_out, ksize_out)

    return infer


@torch.inference_mode()
def calibrate_int8(model, sample_patches, scope: str = "all"):
    """Swap `model`'s convs for int8 ones (`blocks.int8_serve`) and calibrate
    their static activation scales: one forward over `sample_patches` (N, 3,
    h, w) in the compute dtype, with float convs, records each int8 conv's
    abs-max input (the JAX package's `mutable=["quant"]` pass). Returns the
    model, now serving int8 with static scales. Without calibration an int8
    model serves with dynamic scales."""
    int8_serve(model, scope)
    mods = [m for _, m in int8_modules(model)]
    dev = next(model.parameters()).device
    for m in mods:
        m.act_amax, m.calibrating = None, True
    try:
        model(torch.as_tensor(sample_patches, dtype=torch.float32, device=dev), clip_sr=True)
    finally:
        for m in mods:
            m.calibrating = False
    return model


def thresholds_for(test_aiu: bool) -> np.ndarray:
    if test_aiu:
        return np.array([i * 0.01 for i in range(1, 100)], np.float32)
    return np.array([0.5], np.float32)


@torch.inference_mode()
def score_for_ss(cfg, model, dataset, *, device=None, test_aiu: bool = True,
                 test_surface_distance: bool = False, surface_distance_device: bool = True,
                 test_classification_metrics: bool = False,
                 on_image: Optional[Callable] = None, log_fn=print):
    """Score a CrackDataSetTest-style dataset.

    Returns (rows, summary, curves): one dict per image (its metrics, `fname`
    and the host `seconds` it took), the summary dict of the JAX harness
    (PSNR, SSIM, PSNR_kernel, AIU, IoU_max, IoU_max_threshold; with
    `test_classification_metrics` Acc, Sens, Spec; with
    `test_surface_distance` AHD, HD_min, AMSD, MSD_min, on the device or,
    with `surface_distance_device=False`, by the host oracle), and the
    per-threshold arrays (thresholds, aiu, hd, msd; images x thresholds).
    PSNR, SSIM and PSNR_kernel are 0.0 for a model with no SR image to
    score (the inverse model, SCALE_FACTOR 1), as in the JAX harness.
    `on_image(fname, sr_pred, seg_pred, k2d)` sees each image's outputs
    (sr_pred None where the SR is not scored).
    """
    from ..metrics.retinal import get_retinal_seg_metrics
    from ..metrics.surface_distance import calc_distance_metrics

    dev = resolve_device(device)
    infer = build_infer_fn(cfg, model, dev)
    sr_metrics = not cfg.MODEL.SR_SEG_INV and cfg.MODEL.SCALE_FACTOR != 1
    thresholds = thresholds_for(test_aiu)
    th_dev = torch.as_tensor(thresholds, device=dev)

    rows: List[Dict] = []
    aiu_rows, hd_rows, msd_rows, cls_rows = [], [], [], []
    with full_fp32():
        for i, item in enumerate(_prefetched(dataset)):
            t0 = time.perf_counter()
            patches, sr_target, seg_target, kernels, fname, img_ushape, seg_ushape = item
            with record_function("eval.model"):
                sr_p, seg_p, k2d = infer(patches)
                # (1, 3, H, W); the inverse model's SR is a 1-channel seg map
                sr_pred = joint_patch(sr_p, img_ushape).clamp(0.0, 1.0) if sr_metrics else None
                seg_pred = joint_patch(seg_p, seg_ushape)  # (1, 1, H, W)
            sr_t = torch.as_tensor(sr_target, dtype=torch.float32, device=dev)[None]
            seg_t = torch.as_tensor(seg_target, dtype=torch.float32, device=dev)[None]
            kt = torch.as_tensor(kernels, dtype=torch.float32, device=dev)

            row = {"fname": fname, "PSNR_score": 0.0, "SSIM_score": 0.0,
                   "PSNR(Kernel)_score": 0.0}
            if sr_metrics:
                with record_function("eval.sr_metrics"):
                    row.update({
                        "PSNR_score": float(psnr(sr_pred, sr_t)[0]),
                        "SSIM_score": float(ssim(sr_pred, sr_t)[0]),
                        "PSNR(Kernel)_score": float(psnr(k2d.clamp(0, 1)[:, None],
                                                         kt.clamp(0, 1)[:, None]).mean()),
                    })
            with record_function("eval.iou"):
                aiu_rows.append(iou_thresholds(seg_pred, seg_t, th_dev)[0].cpu().numpy())
            row["AIU_scores"] = float(np.mean(aiu_rows[-1]))

            if test_classification_metrics:
                cls_rows.append(get_retinal_seg_metrics(
                    (seg_pred[:, 0] > CLS_THRESHOLD).to(torch.int16).cpu().numpy(),
                    (seg_t[:, 0] > 0.5).to(torch.int16).cpu().numpy()))

            if test_surface_distance and not surface_distance_device:
                # the host oracle over the same bank: (1, T, H, W) vs (1, 1, H, W)
                prob = seg_pred[:, 0].cpu().numpy()
                hd, msd = calc_distance_metrics(prob[:, None] > thresholds[:, None, None],
                                                (seg_t[:, 0] > 0.5).cpu().numpy()[:, None])
                hd_rows.append(hd[0])
                msd_rows.append(msd[0])
            elif test_surface_distance:
                with record_function("eval.hd_bank"):
                    # zero-pad to 64-px multiples (exact: padding adds no contour)
                    h, w = seg_pred.shape[-2:]
                    pad = (0, -(-w // 64) * 64 - w, 0, -(-h // 64) * 64 - h)
                    hd, msd = distance_metrics_banked(
                        F.pad(seg_pred[:, 0], pad), F.pad((seg_t[:, 0] > 0.5).float(), pad),
                        th_dev, max_len=max(h, w),
                    )
                    hd_rows.append(hd[0].cpu().numpy())
                    msd_rows.append(msd[0].cpu().numpy())
            if test_surface_distance:
                row["HD95_scores"] = float(np.mean(hd_rows[-1]))
                row["MSD_scores"] = float(np.mean(msd_rows[-1]))
            if on_image is not None:
                on_image(fname, sr_pred, seg_pred, k2d)
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            if (i + 1) % 10 == 0:
                log_fn(f"estimation {(i + 1) / len(dataset) * 100:.1f} % finish! "
                       f"PSNR_mean:{np.mean([r['PSNR_score'] for r in rows]):.4f} "
                       f"AIU_mean:{np.mean(aiu_rows):.4f}")

    aiu = np.stack(aiu_rows)
    per_th = aiu.mean(axis=0)
    summary = {
        "PSNR": float(np.mean([r["PSNR_score"] for r in rows])),
        "SSIM": float(np.mean([r["SSIM_score"] for r in rows])),
        "PSNR_kernel": float(np.mean([r["PSNR(Kernel)_score"] for r in rows])),
        "AIU": float(aiu.mean()),
        "IoU_max": float(per_th.max()),
        "IoU_max_threshold": float(thresholds[int(per_th.argmax())]),
    }
    if cls_rows:
        summary.update({name: float(np.mean(np.concatenate([np.atleast_1d(c[key])
                                                             for c in cls_rows])))
                        for name, key in (("Acc", "acc"), ("Sens", "sens"), ("Spec", "spec"))})
    curves = {"thresholds": thresholds, "aiu": aiu}
    if hd_rows:
        ahd, amsd = np.stack(hd_rows), np.stack(msd_rows)
        summary.update(AHD=float(ahd.mean()), HD_min=float(ahd.mean(axis=0).min()),
                       AMSD=float(amsd.mean()), MSD_min=float(amsd.mean(axis=0).min()))
        curves.update(hd=ahd, msd=amsd)
    log_fn("estimation finish!!")
    log_fn(f"PSNR_mean:{summary['PSNR']:.4f}  SSIM_mean:{summary['SSIM']:.4f} "
           f"PSNR(Kernel)_mean:{summary['PSNR_kernel']:.4f} AIU_mean:{summary['AIU']:.4f} "
           f"IoU_max:{summary['IoU_max']:.4f}")
    return rows, summary, curves


def write_artifacts(output_dir: str, rows, summary, curves, test_aiu: bool = True):
    """metrics.jsonl (per-image rows, then run means and the distance
    medians), the metric-vs-threshold pngs and iou_log.csv."""
    from ..utils.logging import MetricsLogger

    mlog = MetricsLogger(output_dir)
    for i, row in enumerate(rows):
        mlog.log({k: v for k, v in row.items() if k not in ("fname", "seconds")}, step=i)
    final = {f"{k}_mean": v for k, v in summary.items()}
    if "hd" in curves:
        final["HD95_score_median"] = float(np.median(curves["hd"]))
        final["MSD_score_median"] = float(np.median(curves["msd"]))
    mlog.log(final, step=len(rows))
    mlog.close()
    th = curves["thresholds"]
    if test_aiu:
        plot_metrics_th(curves["aiu"], th, "IoU", output_dir)
    if "hd" in curves:
        for med in (False, True):
            plot_metrics_th(curves["hd"], th, "HD95", output_dir, med=med)
            plot_metrics_th(curves["msd"], th, "MSD", output_dir, med=med)
    save_iou_log(curves["aiu"], th, [r["fname"] for r in rows], output_dir)


def inference_for_ss(cfg, model, dataset, *, output_dir: str, device=None,
                     test_aiu: bool = True, test_surface_distance: bool = False,
                     surface_distance_device: bool = True,
                     test_classification_metrics: bool = False,
                     save_images: bool = False, log_fn=print) -> Dict[str, float]:
    """Score the dataset, write the artifacts, return the summary dict."""
    on_image = None
    if save_images:
        from ..utils.save_output import save_img, save_kernel, save_mask

        thresholds = thresholds_for(test_aiu)
        save_idx = SAVE_IDX if test_aiu else [0]

        def on_image(fname, sr_pred, seg_pred, k2d):
            if sr_pred is not None:
                save_img(output_dir, sr_pred.cpu().numpy(), [fname])
                if cfg.MODEL.SR == "KBPN":  # the one SR net that predicts a kernel
                    save_kernel(output_dir, k2d[:1].cpu().numpy(), [fname])
            seg_np = seg_pred.cpu().numpy()
            for idx in save_idx:
                save_mask(output_dir, (seg_np > thresholds[idx]).astype(np.float32), [fname],
                          thresholds[idx])
            save_mask(output_dir, seg_np, [fname], -1)

    rows, summary, curves = score_for_ss(
        cfg, model, dataset, device=device, test_aiu=test_aiu,
        test_surface_distance=test_surface_distance,
        surface_distance_device=surface_distance_device,
        test_classification_metrics=test_classification_metrics, on_image=on_image,
        log_fn=log_fn)
    write_artifacts(output_dir, rows, summary, curves, test_aiu)
    return summary


def sr_to_uint8(sr: torch.Tensor) -> torch.Tensor:
    """round(clip(sr, 0, 1) * 255) as uint8, on sr's device: the bytes
    `save_img` writes for the float image."""
    return torch.round(sr.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)


@torch.inference_mode()
def tti_outputs(cfg, model, patches, img_ushape, seg_ushape, *, device=None,
                max_patches_per_call: int = 6):
    """One unlabelled image: its patches (N, 3, h, w) go to the device once
    and through the model in chunks of `max_patches_per_call`; the outputs
    stay there and are joined there. Returns (sr uint8 (1, 3, H, W), seg
    float32 (1, 1, H, W), the first patch's kernel (1, k, k)), on the host."""
    dev = resolve_device(device)
    infer = build_infer_fn(cfg, model, dev)
    x = torch.as_tensor(patches, dtype=torch.float32).to(dev)
    srs, segs, k2d = [], [], None
    for s in range(0, x.shape[0], max_patches_per_call):
        sr_p, seg_p, k = infer(x[s:s + max_patches_per_call])
        srs.append(sr_p)
        segs.append(seg_p)
        k2d = k[:1] if k2d is None else k2d
    sr_u8 = sr_to_uint8(joint_patch(torch.cat(srs), img_ushape)).cpu().numpy()
    seg = joint_patch(torch.cat(segs), seg_ushape).cpu().numpy()
    return sr_u8, seg, k2d.cpu().numpy()


def inference_tti(cfg, model, dataset, *, output_dir: str, device=None,
                  max_patches_per_call: int = 6, log_fn=print):
    """Unlabelled real-image inference over a TTICrackDataSetTest: for each
    image, the SR image (images/), the kernel of its first patch for KBPN
    (kernels_max/, kernels_sum/) and the seg map thresholded at the 11 saved
    thresholds plus the raw map (masks/); no metrics."""
    from ..utils.save_output import save_img, save_kernel, save_mask

    thresholds = thresholds_for(True)
    for i, (patches, fname, img_ushape, seg_ushape) in enumerate(_prefetched(dataset)):
        sr_u8, seg, k2d = tti_outputs(cfg, model, patches, img_ushape, seg_ushape,
                                      device=device, max_patches_per_call=max_patches_per_call)
        save_img(output_dir, sr_u8.astype(np.float32) / 255.0, [fname])
        if cfg.MODEL.SR == "KBPN":
            save_kernel(output_dir, k2d, [fname])
        for idx in SAVE_IDX:
            save_mask(output_dir, (seg > thresholds[idx]).astype(np.float32), [fname],
                      thresholds[idx])
        save_mask(output_dir, seg, [fname], -1)
        if (i + 1) % 10 == 0:
            log_fn(f"tti inference {i + 1}/{len(dataset)}")


def plot_metrics_th(scores, thresholds, name, output_dir, med=False):
    """<output_dir>/<name>[_median]_vs_threshold.png; scores (N_images, T)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curve = np.median(scores, axis=0) if med else np.mean(scores, axis=0)
    label = name + ("_median" if med else "")
    fig, ax = plt.subplots(figsize=(5.0, 3.5))
    ax.plot(np.asarray(thresholds), curve, color="#4269d0", linewidth=1.5)
    ax.set_xlabel("threshold")
    ax.set_ylabel(label)
    ax.set_title(f"{label} vs threshold")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    os.makedirs(output_dir, exist_ok=True)
    fig.savefig(os.path.join(output_dir, f"{label}_vs_threshold.png"), dpi=120)
    plt.close(fig)


def save_iou_log(aiu_scores, thresholds, fnames, output_dir):
    """iou_log.csv: one row per image, one column per threshold."""
    import pandas as pd

    os.makedirs(output_dir, exist_ok=True)
    df = pd.DataFrame(aiu_scores, columns=[float(t) for t in thresholds], index=fnames)
    df.to_csv(os.path.join(output_dir, "iou_log.csv"))
