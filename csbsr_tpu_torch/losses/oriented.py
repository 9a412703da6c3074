"""Crack- and failure-oriented loss weights (`csbsr_tpu/losses/oriented.py`).

(B, 1, H, W) maps. The crack-oriented SDM takes one EDT (the min-plus
kernel on the card); every weight is held out of the gradient, as in the
JAX package. The flagship recipe sets all their amplitudes to 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.edt import edt

__all__ = ["crack_oriented_exp_weight", "segment_failure_oriented_exp_weight",
           "oriented_gaussian_map", "crack_oriented_weight", "segment_failure_oriented_weight"]


@torch.no_grad()
def crack_oriented_exp_weight(gt, amp: float, _lambda: float = 2.0):
    """CrackOrientedExpWeight: lambda * exp(-amp * distance to the crack),
    with zero distance for a mask that has no crack pixel."""
    mask = gt[:, 0] > 0.5  # (B, H, W)
    dist = torch.where(mask.flatten(1).any(1)[:, None, None], edt(mask), 0.0)
    return _lambda * torch.exp(-amp * dist)[:, None]


def segment_failure_oriented_exp_weight(pred, gt, amp: float, _lambda: float = 1.0):
    """SegmentFailerOrientedExpWeight: lambda * exp(amp * |pred - gt|), pred
    held out of the gradient."""
    return _lambda * torch.exp(amp * (pred.detach() - gt).abs())


def oriented_gaussian_map(size: int, sigma: float, device=None) -> torch.Tensor:
    """Isotropic Gaussian (size, size), sum-1 normalised then rescaled to max 1."""
    r = size // 2
    g = torch.linspace(-r, r, size, dtype=torch.float32, device=device)
    k = torch.exp(-(g[None, :] ** 2 + g[:, None] ** 2) / (2.0 * sigma**2))
    k = k / k.sum()
    return k / k.max()


def _same_conv_single(x, kernel_2d):
    """(B, 1, H, W) same-padding cross-correlation with one 2-D kernel."""
    pad = (kernel_2d.shape[-1] - 1) // 2
    return F.conv2d(x, kernel_2d[None, None].to(x.dtype), padding=pad)


@torch.no_grad()
def crack_oriented_weight(gt, amp: float, bias: float, size: int = 7, sigma: float = 2.0):
    """CrackOrientedWeight (linear variant): amp * conv(gt, gaussian) + bias."""
    g = oriented_gaussian_map(size, sigma, gt.device)
    return amp * _same_conv_single(gt, g) + bias


def segment_failure_oriented_weight(pred, gt, amp: float, bias: float, size: int = 7,
                                    sigma: float = 2.0):
    """SegmentFailerOrientedWeight: amp * conv(|pred - gt|, gaussian) + bias."""
    g = oriented_gaussian_map(size, sigma, gt.device)
    return amp * _same_conv_single((pred.detach() - gt).abs(), g) + bias
