"""Per-sample blur (`csbsr_tpu/ops/blur.py:batch_blur`).

The pseudo-LR of KBlock blurs every sample with its own kernel at stride 4;
the degradation of the training slice blurs at stride 1. Both are one
grouped convolution over the batch, `groups = B * C`: a cross-correlation
with padding (k-1)//2 on each side, accumulated in float32. The kernel
samplers and generators come with the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["batch_blur"]


def batch_blur(images: torch.Tensor, kernels: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """images (B, C, H, W), kernels (B, k, k) -> (B, C, H', W') in the
    images' dtype, H' = floor((H + 2p - k) / stride) + 1, p = (k - 1) // 2."""
    b, c, h, w = images.shape
    k = kernels.shape[-1]
    acc = torch.float64 if images.dtype == torch.float64 else torch.float32
    x = images.to(acc).reshape(1, b * c, h, w)
    # weight row b*C + c carries sample b's kernel for channel c
    wgt = kernels.to(acc)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    out = F.conv2d(x, wgt, stride=stride, padding=(k - 1) // 2, groups=b * c)
    return out.reshape(b, c, out.shape[-2], out.shape[-1]).to(images.dtype)
