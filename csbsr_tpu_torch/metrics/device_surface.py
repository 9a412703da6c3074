"""Robust surface distances over a threshold bank, on the device
(`csbsr_tpu/metrics/device_surface.py`).

The reference binarises every prediction at 99 thresholds and runs scipy
EDT + marching squares per (image, threshold) on the host. Here the whole
bank is a few batched tensor ops:

  1. 2x2 neighbourhood codes 8*m[i-1,j-1] + 4*m[i-1,j] + 2*m[i,j-1] + m[i,j]
     on the (H+1, W+1) grid of the mask padded by one on every side (the
     JAX package's [[8,4],[2,1]] conv with padding 1), in integer math;
  2. contour length per element from the 16-entry marching-squares table;
  3. the exact EDT (ops/edt.py: the CUDA min-plus kernel on the card) for
     both border maps, two launches per call;
  4. the area-weighted robust percentile by a 35-step bisection on the step
     CDF F(d) = sum(area * [dist <= d]), summed in float32 as the JAX
     package sums it;
  5. the area-weighted mean for MSD.

Empty masks follow the reference harness: both empty -> 0, one empty ->
max(H, W) (or `max_len`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.edt import edt
from ..ops.minplus import minplus_rows

__all__ = ["distance_metrics_banked", "distance_metrics_device"]

_N_BISECT = 35


def _contour_length_table(spacing=(1.0, 1.0)) -> np.ndarray:
    """Marching-squares contour length per 2x2 code (a copy of
    `csbsr_tpu/metrics/surface_distance.py:_contour_length_table`).

    Code bits (MSB->LSB): top-left, top-right, bottom-left, bottom-right.
    A single corner inside (or outside) cuts one diagonal half-segment; two
    adjacent corners give a straight edge; two opposite corners give two
    diagonal half-segments.
    """
    v, h = float(spacing[0]), float(spacing[1])
    diag = 0.5 * math.sqrt(v * v + h * h)
    table = np.zeros(16)
    for code in (0b0001, 0b0010, 0b0100, 0b1000, 0b0111, 0b1011, 0b1101, 0b1110):
        table[code] = diag
    table[0b0101] = table[0b1010] = v
    table[0b0011] = table[0b1100] = h
    table[0b0110] = table[0b1001] = 2 * diag
    return table


def _codes(mask: torch.Tensor, table: torch.Tensor):
    """mask (..., H, W) bool -> (areas, borders) on the (H+1, W+1) grid."""
    m = F.pad(mask.to(torch.int32), (1, 1, 1, 1))
    code = 8 * m[..., :-1, :-1] + 4 * m[..., :-1, 1:] + 2 * m[..., 1:, :-1] + m[..., 1:, 1:]
    borders = (code != 0) & (code != 0b1111)
    areas = torch.where(borders, table[code.long()], 0.0)
    return areas, borders


def _weighted_percentile(dist, weight, frac: float, hi0: float):
    """Smallest d of the weighted distance set with CDF(d) >= frac, by
    bisection on the right-continuous step function; dist and weight
    broadcast over the trailing two axes."""
    dist, weight = torch.broadcast_tensors(dist, weight)
    total = weight.sum(dim=(-2, -1))
    target = frac * total
    lo = torch.zeros_like(total)
    hi = torch.full_like(total, hi0)
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        ge = (weight * (dist <= mid[..., None, None])).sum(dim=(-2, -1)) >= target
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def distance_metrics_device(pred_bank: torch.Tensor, gt: torch.Tensor,
                            percentile: float = 50.0, max_len=None,
                            row_pass=minplus_rows):
    """Batched robust HD + MSD over a threshold bank.

    pred_bank (B, T, H, W) bool/0-1, gt (B, H, W) bool/0-1 -> (hd, msd),
    each (B, T) float32. `row_pass` is the EDT's min-plus row pass; only a
    check against the plain version passes another.
    """
    b, t, h, w = pred_bank.shape
    dev = pred_bank.device
    table = torch.as_tensor(_contour_length_table(), dtype=torch.float32, device=dev)
    max_len = float(max(h, w) if max_len is None else max_len)
    frac = float(percentile) / 100.0
    hi0 = math.hypot(h + 1, w + 1) + 1.0

    w_g, borders_g = _codes(gt > 0.5, table)  # (B, H+1, W+1)
    w_p, borders_p = _codes(pred_bank > 0.5, table)  # (B, T, H+1, W+1)

    dist_to_g = edt(borders_g, row_pass)
    dist_to_p = edt(borders_p.reshape(b * t, h + 1, w + 1), row_pass).reshape(b, t, h + 1, w + 1)

    tot_g = w_g.sum(dim=(-2, -1))[:, None]  # (B, 1)
    tot_p = w_p.sum(dim=(-2, -1))  # (B, T)

    hd = torch.maximum(
        _weighted_percentile(dist_to_p, w_g[:, None], frac, hi0),
        _weighted_percentile(dist_to_g[:, None], w_p, frac, hi0),
    )
    msd_gp = (w_g[:, None] * dist_to_p).sum(dim=(-2, -1)) / torch.clamp(tot_g, min=1e-30)
    msd_pg = (w_p * dist_to_g[:, None]).sum(dim=(-2, -1)) / torch.clamp(tot_p, min=1e-30)
    msd = 0.5 * (msd_gp + msd_pg)

    g_empty, p_empty = tot_g == 0, tot_p == 0
    both, either = g_empty & p_empty, g_empty | p_empty
    hd = torch.where(both, 0.0, torch.where(either, max_len, hd))
    msd = torch.where(both, 0.0, torch.where(either, max_len, msd))
    return hd.float(), msd.float()


def distance_metrics_banked(prob: torch.Tensor, gt: torch.Tensor, thresholds: torch.Tensor,
                            percentile: float = 50.0, max_len=None, row_pass=minplus_rows):
    """Binarise prob (B, H, W) at a threshold bank (T,) and score HD/MSD
    against gt (B, H, W): -> (hd, msd), each (B, T).

    `max_len` overrides the one-mask-empty value: pass max(orig_H, orig_W)
    when prob/gt were zero-padded (padding is otherwise exact: padded
    elements carry no contour and leave the EDT at original pixels alone).
    """
    bank = prob.float()[:, None] > thresholds.float()[None, :, None, None]
    return distance_metrics_device(bank, gt, percentile, max_len, row_pass)
