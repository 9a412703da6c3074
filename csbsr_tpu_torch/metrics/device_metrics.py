"""On-device metrics (`csbsr_tpu/metrics/device_metrics.py`): PSNR, SSIM
and IoU over a threshold bank, on NCHW tensors, in float32."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "iou_thresholds"]


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR on [0, 1] images, 10*log10(1/MSE) per sample. (B, C, H, W) -> (B,)."""
    mse = ((img1.float() - img2.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / mse)


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / float(2 * sigma**2))
                  for x in range(window_size)])
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """SSIM with an 11x11 Gaussian window (sigma 1.5), zero padding, mean per
    sample. (B, C, H, W) -> (B,)."""
    c = img1.shape[1]
    w = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(img1.device)
    w = w[None, None].expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def conv(x):
        return F.conv2d(x, w, padding=pad, groups=c)

    img1, img2 = img1.float(), img2.float()
    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def iou_thresholds(output: torch.Tensor, target: torch.Tensor,
                   thresholds: torch.Tensor) -> torch.Tensor:
    """IoU at a bank of thresholds: output > th against target > 0.5, smooth
    1e-5. output/target (B, 1, H, W), thresholds (T,) -> (B, T)."""
    smooth = 1e-5
    o = output.float()[:, 0][:, None]  # (B, 1, H, W)
    t = (target.float()[:, 0] > 0.5)[:, None]
    ob = o > thresholds.float()[None, :, None, None]
    inter = (ob & t).sum(dim=(2, 3)).float()
    union = (ob | t).sum(dim=(2, 3)).float()
    return (inter + smooth) / (union + smooth)
