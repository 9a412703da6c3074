"""Exact Euclidean distance transform (`csbsr_tpu/ops/edt.py`).

  pass 1 (columns): distance along H to the nearest True pixel, in the
          closed form f_i = i + cummin_{k<=i}(g0_k - k) and
          b_i = -i + revcummin_{k>=i}(g0_k + k) (`torch.cummin`, with a flip
          for the reverse pass);
  pass 2 (rows):    d2[i, j] = min_k g[i, k]^2 + (j - k)^2, the min-plus row
          pass (ops/minplus.py: the CUDA kernel on the card, the plain
          version on the CPU).

Equals `scipy.ndimage.distance_transform_edt(~mask)` per 2-D slice.

`signed_distance_map` and `sdf_normalized` (the boundary loss's target SDF)
take two EDTs each, so two launches of the row-pass kernel on the card. They
run under `torch.no_grad()`: the JAX package stops the SDF's gradient, and
the kernel has no backward.
"""
from __future__ import annotations

import torch

from .minplus import BIG, minplus_rows

__all__ = ["edt", "find_boundaries_inner", "signed_distance_map", "sdf_normalized"]


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


def _any_true(m: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 1, 1): whether the slice has a True pixel."""
    return m.flatten(-2).any(-1)[..., None, None]


@torch.no_grad()
def signed_distance_map(mask: torch.Tensor, row_pass=minplus_rows) -> torch.Tensor:
    """Unnormalised SDM, negdist - posdist (reference `compute_sdf`); zero
    for a slice with no True pixel."""
    m = mask.to(torch.bool)
    posdis, negdis = edt(m, row_pass), edt(~m, row_pass)
    return torch.where(_any_true(m), negdis - posdis, 0.0)


@torch.no_grad()
def sdf_normalized(mask: torch.Tensor, row_pass=minplus_rows) -> torch.Tensor:
    """Normalised SDF in [-1, 1] (reference `compute_sdf1_1`):
    norm01(distance to the background) - norm01(distance to the mask), zero
    on the inner boundary and for a slice with no True pixel. mask (..., H, W)."""
    m = mask.to(torch.bool)
    any_pos = _any_true(m)
    posdis = torch.where(any_pos, edt(~m, row_pass), 0.0)
    negdis = torch.where(any_pos, edt(m, row_pass), 0.0)

    def norm01(d):
        dmin = d.amin(dim=(-2, -1), keepdim=True)
        dmax = d.amax(dim=(-2, -1), keepdim=True)
        return (d - dmin) / torch.where(dmax > dmin, dmax - dmin, 1.0)

    sdf = norm01(negdis) - norm01(posdis)
    sdf = torch.where(find_boundaries_inner(m), 0.0, sdf)
    return torch.where(any_pos, sdf, 0.0)
