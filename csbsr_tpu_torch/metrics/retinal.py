"""Retinal classification metrics: accuracy / sensitivity / specificity
(`csbsr_tpu/metrics/retinal.py`, the port's own copy of that numpy code):
per-sample confusion-count metrics on binarised maps."""
from __future__ import annotations

import numpy as np


def get_retinal_seg_metrics(seg: np.ndarray, ground: np.ndarray, metrics=("acc", "sens", "spec")):
    """seg/ground: (B, H, W) or (B, H, W, 1) binary arrays; returns
    {"acc", "sens", "spec"}: one value per sample each."""
    seg = np.asarray(seg).astype(np.int16)
    ground = np.asarray(ground).astype(np.int16)
    if seg.ndim == 4:
        seg = seg[..., 0]
    if ground.ndim == 4:
        ground = ground[..., 0]
    out = {}
    tp = np.sum(ground * seg, axis=(1, 2))
    tn = np.sum((ground == 0) * (seg == 0), axis=(1, 2))
    if "acc" in metrics:
        tot = ground[0].size
        out["acc"] = (tp + tn) / tot if tot else np.ones_like(tp, float)
    if "sens" in metrics:
        denom = np.sum(ground, axis=(1, 2))
        sens = np.divide(tp, denom, out=np.ones_like(tp, float), where=denom != 0)
        out["sens"] = sens
    if "spec" in metrics:
        denom = np.sum(ground == 0, axis=(1, 2))
        spec = np.divide(tn, denom, out=np.ones_like(tn, float), where=denom != 0)
        out["spec"] = spec
    return out
