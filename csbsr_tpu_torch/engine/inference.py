"""Test-time evaluation (`csbsr_tpu/engine/inference.py:inference_for_ss`).

Patched LR -> model -> patch reassembly -> PSNR/SSIM/kernel-PSNR, IoU at 99
thresholds (AIU) and, optionally, HD/MSD over the same 99-threshold bank on
the device (metrics/device_surface.py, whose EDT row pass is the CUDA
min-plus kernel on the card).

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
from ..ops.patch import joint_patch
from ..utils.device import full_fp32, resolve_device


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
    Eval BN has no batch dependence, so any patch count runs as it is."""
    ksize_out = int(cfg.BLUR.KERNEL_SIZE_OUTPUT)

    @torch.inference_mode()
    def infer(patches):
        x = torch.as_tensor(patches, dtype=torch.float32, device=device)
        out = model(x, clip_sr=True)
        kvec = out["kernel"].float()
        kvec = kvec / kvec.sum(dim=-1, keepdim=True)
        return out["sr"].float(), out["seg"].float(), kvec.reshape(-1, ksize_out, ksize_out)

    return infer


def thresholds_for(test_aiu: bool) -> np.ndarray:
    if test_aiu:
        return np.array([i * 0.01 for i in range(1, 100)], np.float32)
    return np.array([0.5], np.float32)


@torch.inference_mode()
def score_for_ss(cfg, model, dataset, *, device=None, test_aiu: bool = True,
                 test_surface_distance: bool = False,
                 on_image: Optional[Callable] = None, log_fn=print):
    """Score a CrackDataSetTest-style dataset.

    Returns (rows, summary, curves): one dict per image (its metrics, `fname`
    and the host `seconds` it took), the summary dict of the JAX harness
    (PSNR, SSIM, PSNR_kernel, AIU, IoU_max, IoU_max_threshold and, with
    `test_surface_distance`, AHD, HD_min, AMSD, MSD_min), and the
    per-threshold arrays (thresholds, aiu, hd, msd; images x thresholds).
    `on_image(fname, sr_pred, seg_pred, k2d)` sees each image's outputs.
    """
    dev = resolve_device(device)
    infer = build_infer_fn(cfg, model, dev)
    thresholds = thresholds_for(test_aiu)
    th_dev = torch.as_tensor(thresholds, device=dev)

    rows: List[Dict] = []
    aiu_rows, hd_rows, msd_rows = [], [], []
    with full_fp32():
        for i, item in enumerate(_prefetched(dataset)):
            t0 = time.perf_counter()
            patches, sr_target, seg_target, kernels, fname, img_ushape, seg_ushape = item
            with record_function("eval.model"):
                sr_p, seg_p, k2d = infer(patches)
                sr_pred = joint_patch(sr_p, img_ushape).clamp(0.0, 1.0)  # (1, 3, H, W)
                seg_pred = joint_patch(seg_p, seg_ushape)  # (1, 1, H, W)
            sr_t = torch.as_tensor(sr_target, dtype=torch.float32, device=dev)[None]
            seg_t = torch.as_tensor(seg_target, dtype=torch.float32, device=dev)[None]
            kt = torch.as_tensor(kernels, dtype=torch.float32, device=dev)

            with record_function("eval.sr_metrics"):
                row = {
                    "fname": fname,
                    "PSNR_score": float(psnr(sr_pred, sr_t)[0]),
                    "SSIM_score": float(ssim(sr_pred, sr_t)[0]),
                    "PSNR(Kernel)_score": float(psnr(k2d.clamp(0, 1)[:, None],
                                                     kt.clamp(0, 1)[:, None]).mean()),
                }
            with record_function("eval.iou"):
                aiu_rows.append(iou_thresholds(seg_pred, seg_t, th_dev)[0].cpu().numpy())
            row["AIU_scores"] = float(np.mean(aiu_rows[-1]))

            if test_surface_distance:
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
                     save_images: bool = False, log_fn=print) -> Dict[str, float]:
    """Score the dataset, write the artifacts, return the summary dict."""
    on_image = None
    if save_images:
        from ..utils.save_output import save_img, save_kernel, save_mask

        thresholds = thresholds_for(test_aiu)
        save_idx = [0] + [9 + i * 10 for i in range(9)] + [98] if test_aiu else [0]

        def on_image(fname, sr_pred, seg_pred, k2d):
            save_img(output_dir, sr_pred.cpu().numpy(), [fname])
            save_kernel(output_dir, k2d[:1].cpu().numpy(), [fname])
            seg_np = seg_pred.cpu().numpy()
            for idx in save_idx:
                save_mask(output_dir, (seg_np > thresholds[idx]).astype(np.float32), [fname],
                          thresholds[idx])
            save_mask(output_dir, seg_np, [fname], -1)

    rows, summary, curves = score_for_ss(
        cfg, model, dataset, device=device, test_aiu=test_aiu,
        test_surface_distance=test_surface_distance, on_image=on_image, log_fn=log_fn)
    write_artifacts(output_dir, rows, summary, curves, test_aiu)
    return summary


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
