"""Min-plus row pass of the exact EDT: CUDA kernel and plain version.

    d2[..., r, j] = min_k ( min(g[..., r, k]^2, 1e9) + (j - k)^2 )

On a CUDA tensor `minplus_rows` launches `csrc/minplus.cu` (the port of the
Pallas kernel `csbsr_tpu/ops/pallas/minplus.py:minplus_rows_pallas`); on a
CPU tensor it runs `minplus_rows_reference`, the blocked form of the JAX
package's `_min_plus_rows`. Empty slices (no True pixel) are capped at 1e9,
the XLA path's value; the Pallas kernel caps at 1e18, and every caller masks
such slices. Away from that cap all terms are integers below 2**24 for
H, W <= 2896, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

__all__ = ["minplus_rows", "minplus_rows_reference", "BIG"]

BIG = 1e9
_BLOCK = 32
_NAME = "minplus"
# (g, out, rows, W, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def minplus_rows_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, blocked over j so the (..., H, W, block)
    temporary stays bounded."""
    w = g.shape[-1]
    g2 = torch.minimum(g * g, torch.tensor(BIG, dtype=g.dtype, device=g.device))
    k = torch.arange(w, dtype=torch.float32, device=g.device)
    out = torch.empty_like(g2)
    for j0 in range(0, w, _BLOCK):
        j = torch.arange(j0, min(j0 + _BLOCK, w), dtype=torch.float32, device=g.device)
        sq = (j[None, :] - k[:, None]) ** 2  # (W, block)
        out[..., j0 : j0 + j.numel()] = torch.amin(g2[..., :, None] + sq, dim=-2)
    return out


def minplus_rows(g: torch.Tensor) -> torch.Tensor:
    """The row pass: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor. g: (..., W) float32, contiguous, at least 2-D."""
    if g.device.type == "cpu":
        return minplus_rows_reference(g)
    if g.device.type != "cuda":
        raise ValueError(f"minplus_rows: unsupported device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"minplus_rows: float32 expected, got {g.dtype}")
    if g.dim() < 2:
        raise ValueError(f"minplus_rows: (..., H, W) expected, got shape {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("minplus_rows: contiguous input expected")
    fn = cuda_build.load(_NAME, "csbsr_minplus_rows", _ARGTYPES)
    out = torch.empty_like(g)
    w = g.shape[-1]
    rows = g.numel() // w if w else 0
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), out.data_ptr(), rows, w, stream)
    cuda_build.check_launch("minplus_rows", err)
    cuda_build.LAUNCHES["minplus_rows"] += 1
    return out
