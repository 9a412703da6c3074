"""Exact Euclidean distance transform (`csbsr_tpu/ops/edt.py`).

  pass 1 (columns): distance along H to the nearest True pixel, in the
          closed form f_i = i + cummin_{k<=i}(g0_k - k) and
          b_i = -i + revcummin_{k>=i}(g0_k + k) (`torch.cummin`, with a flip
          for the reverse pass);
  pass 2 (rows):    d2[i, j] = min_k g[i, k]^2 + (j - k)^2, the min-plus row
          pass (ops/minplus.py: the CUDA kernel on the card, the plain
          version on the CPU).

Equals `scipy.ndimage.distance_transform_edt(~mask)` per 2-D slice.
"""
from __future__ import annotations

import torch

from .minplus import BIG, minplus_rows

__all__ = ["edt", "find_boundaries_inner"]


def _column_distance(mask: torch.Tensor) -> torch.Tensor:
    """Distance in rows (axis -2) to the nearest True; (..., H, W) float32."""
    g0 = torch.where(mask, 0.0, BIG).to(torch.float32)
    h = g0.shape[-2]
    idx = torch.arange(h, dtype=torch.float32, device=mask.device).reshape(h, 1)
    f = idx + torch.cummin(g0 - idx, dim=-2).values
    rev = torch.cummin(torch.flip(g0 + idx, dims=(-2,)), dim=-2).values
    b = -idx + torch.flip(rev, dims=(-2,))
    return torch.minimum(f, b)


def edt(mask: torch.Tensor, row_pass=minplus_rows) -> torch.Tensor:
    """Exact distance to the nearest True pixel, per 2-D slice.

    mask: bool (..., H, W). Returns float32 distances, 0 inside the mask; a
    slice with no True pixel gets sqrt(1e9)-scale values (callers mask it).
    `row_pass` is the min-plus row pass; only a check against the plain
    version passes another.
    """
    g = _column_distance(mask.to(torch.bool)).contiguous()
    return torch.sqrt(row_pass(g))


def find_boundaries_inner(mask: torch.Tensor) -> torch.Tensor:
    """skimage `find_boundaries(mode='inner')` for 2-D bool masks (..., H, W):
    True pixels with at least one False 4-neighbour (outside counts as True)."""
    m = mask.to(torch.bool)
    p = torch.nn.functional.pad(m, (1, 1, 1, 1), value=True)
    up, down = p[..., :-2, 1:-1], p[..., 2:, 1:-1]
    left, right = p[..., 1:-1, :-2], p[..., 1:-1, 2:]
    return m & ~(up & down & left & right)
