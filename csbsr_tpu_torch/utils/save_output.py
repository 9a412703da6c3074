"""Output savers (`csbsr_tpu/utils/save_output.py`): prediction images,
per-threshold masks, kernels. Arrays are NCHW float in [0, 1] (kernels
(N, k, k)); PIL is imported only here."""
from __future__ import annotations

import os
from typing import List

import numpy as np


def _to_pil(arr: np.ndarray):
    """(C, H, W) or (H, W) float in [0, 1] -> 8-bit PIL image."""
    from PIL import Image

    arr = np.clip(arr, 0.0, 1.0)
    if arr.ndim == 3:
        arr = arr[0] if arr.shape[0] == 1 else np.transpose(arr, (1, 2, 0))
    mode = "L" if arr.ndim == 2 else "RGB"
    return Image.fromarray((arr * 255).round().astype(np.uint8), mode=mode)


def save_img(output_dir: str, imgs: np.ndarray, fnames: List[str]):
    d = os.path.join(output_dir, "images")
    os.makedirs(d, exist_ok=True)
    for img, fname in zip(np.asarray(imgs), fnames):
        _to_pil(img).save(os.path.join(d, fname))


def save_mask(output_dir: str, masks: np.ndarray, fnames: List[str], threshold: float):
    sub = "raw" if threshold < 0 else f"th_{threshold:.2f}"
    d = os.path.join(output_dir, "masks", sub)
    os.makedirs(d, exist_ok=True)
    for mask, fname in zip(np.asarray(masks), fnames):
        _to_pil(mask).save(os.path.join(d, fname.replace(".jpg", ".png")))


def save_kernel(output_dir: str, kernels: np.ndarray, fnames: List[str]):
    """Max- and sum-normalised kernel dumps."""
    for sub, norm in (("kernels_max", "max"), ("kernels_sum", "sum")):
        d = os.path.join(output_dir, sub)
        os.makedirs(d, exist_ok=True)
        for k, fname in zip(np.asarray(kernels), fnames):
            k = k.astype(np.float64)
            if norm == "max":
                k = k / max(k.max(), 1e-12)
            else:
                k = np.clip(k / max(k.sum(), 1e-12) * 50, 0, 1)
            _to_pil(k).save(os.path.join(d, fname.replace(".jpg", ".png")))
