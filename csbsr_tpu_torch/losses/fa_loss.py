"""DSRL's feature-affinity loss (`csbsr_tpu/losses/fa_loss.py`).

Both feature maps are average-pooled by int(1 / subscale) (16 by default),
each pooled map gives the Gram matrix of its spatial positions (B, hw, hw),
and the loss is the sum of the absolute differences of the two matrices
divided by (h * w)^2. NCHW; the math runs in the inputs' dtype (the loss
glue passes float32, or float64 in a float64 run).
"""
from __future__ import annotations

import torch

from ..ops.resize import adaptive_avg_pool

__all__ = ["fa_loss"]


def _gram(feature: torch.Tensor, s: int) -> torch.Tensor:
    f = adaptive_avg_pool(feature, (feature.shape[2] // s, feature.shape[3] // s))
    f = f.flatten(2)  # (B, C, hw), positions row-major
    return f.transpose(1, 2) @ f


def fa_loss(feature1: torch.Tensor, feature2: torch.Tensor,
            subscale: float = 0.0625) -> torch.Tensor:
    """Scalar FA loss of two (B, C, H, W) maps of the same size."""
    s = int(1 / subscale)
    h, w = feature1.shape[2] // s, feature1.shape[3] // s
    return (_gram(feature2, s) - _gram(feature1, s)).abs().sum() / float((h * w) ** 2)
