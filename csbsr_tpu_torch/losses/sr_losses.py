"""SR losses (`csbsr_tpu/losses/sr_losses.py`): L1/L2 and the KBPN composite.

(B, C, H, W) tensors. The pseudo-LR is one grouped convolution over the
batch (ops/blur.batch_blur) and a bicubic 1/SF resize.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.blur import batch_blur
from ..ops.resize import resize
from .oriented import (crack_oriented_exp_weight, crack_oriented_weight,
                       segment_failure_oriented_exp_weight, segment_failure_oriented_weight)

__all__ = ["l1_per_sample", "l2_per_sample", "get_pseudo_lr", "kbpn_loss"]


def l1_per_sample(pred, target):
    return (pred - target).abs().mean(dim=(1, 2, 3))


def l2_per_sample(pred, target):
    return ((pred - target) ** 2).mean(dim=(1, 2, 3))


def get_pseudo_lr(sr, kernel_vec, ksize: int, scale_factor: int, method: str = "bicubic"):
    """Blur the SR prediction with its own sum-1 kernel and downsample by
    1/SF. kernel_vec (B, k^2) -> (lr_pred (B, C, H/SF, W/SF), kernel_2d (B, k, k))."""
    vec = kernel_vec / kernel_vec.sum(dim=-1, keepdim=True)
    weight = vec.reshape(-1, ksize, ksize)
    blurred = batch_blur(sr, weight, stride=1)
    h, w = blurred.shape[-2:]
    return resize(blurred, (h // scale_factor, w // scale_factor), method=method), weight


def kbpn_loss(hr_pred, hr_target, lr_target, kernel_pred_vec, gt_kernel_2d, iteration, *,
              ksize: int, scale_factor: int, weights: Sequence[float] = (0.4, 0.4, 0.2),
              only_kernel_loss_in_window=None, segment_preds=None, segment_targets=None,
              co_amp: float = 0.0, sfo_amp: float = 0.0, co_bias: float = 1.0,
              sfo_bias: float = 1.0, weight_iter: int = -1, weight_variant: str = "exp",
              gaus_size: int = 7, gaus_sigma: float = 2.0,
              downscale_method: str = "bicubic") -> Tuple[torch.Tensor, torch.Tensor]:
    """KBPNLoss: w0 * L1(HR) + w1 * L1(pseudo-LR) + w2 * MSE(kernel), per
    sample; inside the kernel-pretrain window (`only_kernel_loss_in_window`
    true) the kernel MSE alone. Returns (loss (B,), kernel_pred_2d (B, k, k)).

    Only weights[0:3] are read: the recipes' default `[0.4, 0.4, 0, 2]` is
    the reference's typo for [0.4, 0.4, 0.2], so they train with kernel-MSE
    weight 0, and so does this loss."""
    gt_kernel_2d = gt_kernel_2d.reshape(gt_kernel_2d.shape[0], ksize, ksize)
    hr_map = (hr_pred - hr_target).abs()
    lr_pred, kernel_2d = get_pseudo_lr(hr_pred, kernel_pred_vec, ksize, scale_factor,
                                       downscale_method)
    lr_map = (lr_pred - lr_target).abs()
    kernel_map = (kernel_2d - gt_kernel_2d.to(kernel_2d.dtype)) ** 2

    if weight_iter != -1 and (co_amp != 0.0 or sfo_amp != 0.0) and iteration > weight_iter:
        if co_amp != 0.0:
            w = (crack_oriented_weight(segment_targets, co_amp, co_bias, gaus_size, gaus_sigma)
                 if weight_variant == "linear"
                 else crack_oriented_exp_weight(segment_targets, co_amp))
            hr_map = w * hr_map
            lr_map = resize(w, lr_map.shape[-2:], method="bilinear") * lr_map
        if sfo_amp != 0.0:
            w = (segment_failure_oriented_weight(segment_preds, segment_targets, sfo_amp,
                                                 sfo_bias, gaus_size, gaus_sigma)
                 if weight_variant == "linear"
                 else segment_failure_oriented_exp_weight(segment_preds, segment_targets,
                                                          sfo_amp))
            hr_map = w * hr_map
            lr_map = resize(w, lr_map.shape[-2:], method="bilinear") * lr_map

    w0, w1, w2 = weights[0], weights[1], weights[2]
    kernel_mse = kernel_map.mean(dim=(1, 2))
    loss = w0 * hr_map.mean(dim=(1, 2, 3)) + w1 * lr_map.mean(dim=(1, 2, 3)) + w2 * kernel_mse
    if only_kernel_loss_in_window:
        loss = kernel_mse
    return loss, kernel_2d
