"""Resizes the flagship path needs, with the JAX package's semantics.

`csbsr_tpu/ops/resize.py` builds numpy interpolation matrices that follow
torch's `F.interpolate`: Keys cubic with A=-0.75, bilinear with either
`align_corners`, clamped borders, no antialiasing, and AdaptiveAvgPool
windows for "area". So the port calls `F.interpolate` /
`F.adaptive_avg_pool2d` directly; `tests/test_torch_port_ops.py` holds them
to the matrix form. As in the JAX package the arithmetic is float32 and the
result comes back in the input's dtype.

Tensors are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import upcast

__all__ = ["resize", "adaptive_avg_pool"]


def resize(x: torch.Tensor, out_hw, method: str = "bicubic",
           align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing (H, W) of an NCHW tensor: 'bicubic' | 'bilinear'."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    if method not in ("bicubic", "bilinear"):
        raise NotImplementedError(method)
    out = F.interpolate(upcast(x), size=out_hw, mode=method, align_corners=align_corners)
    return out.to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d in float32, result in the input's dtype."""
    return F.adaptive_avg_pool2d(upcast(x), tuple(out_hw)).to(x.dtype)
