"""Segmentation losses (`csbsr_tpu/losses/seg_losses.py`).

Pure functions on (B, 1, H, W) tensors returning per-sample (B,) losses (the
reference's reduction='none'), or per-pixel maps with `per_pixel=True`. The
BoundaryCombo alpha is an explicit argument. The boundary term's SDF comes
from ops/edt.sdf_normalized (the min-plus kernel on the card), without a
gradient; a caller that scores several predictions against one target may
pass the target's SDF in once (`sdf=`).

The BoundaryCombo alpha is a float32 scalar in the JAX package, which
forms its coefficients (1 - alpha, and alpha times the BCE/Dice share of
the per-pixel map) in float32 even in a float64 run; `_f32` rounds them
the same way, which a float32 run does anyway.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.edt import sdf_normalized

__all__ = ["weighted_bce", "binary_dice", "generalized_dice", "bce_dice", "boundary_sdf",
           "boundary_loss", "boundary_combo_loss", "boundary_gdice_loss",
           "generalized_boundary_combo_loss", "bce", "cross_entropy_loss_rcf"]

_SMOOTH_BCE = 1e-8


def _f32(x) -> float:
    """x rounded to float32 (a coefficient the JAX package forms in float32)."""
    return float(np.float32(x))


def weighted_bce(predict, target, pos_weight: Sequence[float] = (1, 1), per_pixel=False):
    """WeightedBCELoss, mean over CHW per sample.

    The complement is clipped before its log instead of the reference's
    literal `log(1 - p + eps)`: a compiler may reassociate `1 - p + eps`
    into `(1 + eps) - p`, which rounds back to `1 - p` in float32, so a
    probability saturated to exactly 1.0 (as bf16 sigmoids do) gives
    log(0) = -inf and then 0 * inf = NaN. The clip is an order barrier, and
    equals the reference's arithmetic for every p <= 1 - eps."""
    p = predict.clamp_min(_SMOOTH_BCE)
    q = (1.0 - p).clamp_min(_SMOOTH_BCE)
    w0, w1 = pos_weight
    loss = -(w0 * target * torch.log(p + _SMOOTH_BCE)
             + w1 * (1.0 - target) * torch.log(q + _SMOOTH_BCE)) / (w0 + w1)
    return loss if per_pixel else loss.mean(dim=(1, 2, 3))


def binary_dice(predict, target, smooth: float = 1e-6, p: int = 2, per_pixel=False):
    """BinaryDiceLoss, per sample. per_pixel=True is the reference's out_map
    variant as it stands: the numerator sums over channels only, the
    denominator over the whole batch."""
    if per_pixel:
        num = 2.0 * (predict * target).sum(dim=1, keepdim=True) + smooth
        den = (predict**p + target**p).sum() + smooth
        return 1.0 / target.numel() - num / den
    pred, tgt = predict.reshape(predict.shape[0], -1), target.reshape(target.shape[0], -1)
    num = 2.0 * (pred * tgt).sum(dim=1) + smooth
    den = (pred**p + tgt**p).sum(dim=1) + smooth
    return 1.0 - num / den


def generalized_dice(predict, target, smooth: float = 1e-5):
    """GDiceLoss, binary channel case."""
    w = 1.0 / (target.sum(dim=(2, 3)) ** 2 + 1e-10)  # (B, C)
    inter = w * (predict * target).sum(dim=(2, 3))
    union = w * (predict.sum(dim=(2, 3)) + target.sum(dim=(2, 3)))
    return 1.0 - 2.0 * (inter.sum(dim=-1) + smooth) / (union.sum(dim=-1) + smooth)


def bce_dice(predict, target, pos_weight: Sequence[float] = (1, 1),
             loss_weight: Sequence[float] = (1, 1), gdice: bool = False, per_pixel: bool = False):
    """BCE_DiceLoss."""
    wbce = weighted_bce(predict, target, pos_weight, per_pixel=per_pixel)
    dice = generalized_dice(predict, target) if gdice else binary_dice(
        predict, target, per_pixel=per_pixel)
    lw0, lw1 = loss_weight
    return (lw0 * wbce + lw1 * dice) / (lw0 + lw1)


def boundary_sdf(target: torch.Tensor) -> torch.Tensor:
    """The boundary term's SDF of a binary target (B, C, H, W), float32."""
    return sdf_normalized(target > 0.5)


def boundary_loss(predict, target, per_pixel=False, sdf: Optional[torch.Tensor] = None):
    """BoundaryLoss: mean(pred * normalised SDF of the target)."""
    sdf = boundary_sdf(target) if sdf is None else sdf
    mult = predict * sdf.to(predict.dtype)
    return mult if per_pixel else mult.mean(dim=(1, 2, 3))


def boundary_combo_loss(predict, target, alpha, pos_weight: Sequence[float] = (1, 1),
                        loss_weight: Sequence[float] = (1, 1), per_pixel: bool = False,
                        sdf: Optional[torch.Tensor] = None):
    """BoundaryComboLoss: alpha * BCE_Dice + (1 - alpha) * Boundary, with
    predict clamped to >= 1e-8.

    per_pixel=True returns the reference's (B, B, H, W) out_map in two
    factors (its WBCE map of sample i meets the dice map of sample j for all
    i, j by broadcasting): paired[i] = alpha*c0*bce[i] + (1-alpha)*bd[i] and
    cross[j] = alpha*c1*dice[j]; the caller reduces map[i, j] =
    paired[i] + cross[j] without building B^2 maps."""
    predict = predict.clamp_min(_SMOOTH_BCE)
    if per_pixel:
        lw0, lw1 = loss_weight
        bce_map = weighted_bce(predict, target, pos_weight, per_pixel=True)
        dice_map = binary_dice(predict, target, per_pixel=True)
        bd_map = boundary_loss(predict, target, per_pixel=True, sdf=sdf)
        paired = (_f32(alpha * _f32(lw0 / (lw0 + lw1))) * bce_map
                  + _f32(1.0 - alpha) * bd_map)
        cross = _f32(alpha * _f32(lw1 / (lw0 + lw1))) * dice_map
        return paired, cross
    wd = bce_dice(predict, target, pos_weight, loss_weight)
    return alpha * wd + _f32(1.0 - alpha) * boundary_loss(predict, target, sdf=sdf)


def boundary_gdice_loss(predict, target, alpha, sdf: Optional[torch.Tensor] = None):
    """Boundary_GDiceLoss."""
    predict = predict.clamp_min(_SMOOTH_BCE)
    return alpha * generalized_dice(predict, target) + _f32(1.0 - alpha) * boundary_loss(
        predict, target, sdf=sdf)


def generalized_boundary_combo_loss(predict, target, alpha, pos_weight: Sequence[float] = (1, 1),
                                    loss_weight: Sequence[float] = (1, 1),
                                    sdf: Optional[torch.Tensor] = None):
    """GeneralizedBoundaryComboLoss."""
    predict = predict.clamp_min(_SMOOTH_BCE)
    wd = bce_dice(predict, target, pos_weight, loss_weight, gdice=True)
    return alpha * wd + _f32(1.0 - alpha) * boundary_loss(predict, target, sdf=sdf)


def bce(predict, target):
    """torch nn.BCELoss() per sample (the 'BCE' option)."""
    p = predict.clamp(1e-7, 1.0 - 1e-7)
    return (-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))).mean(dim=(1, 2, 3))


def cross_entropy_loss_rcf(prediction, label):
    """CrackFormer's class-balanced BCE, summed per sample: positives
    (label > 0.5) weighted beta, negatives 1.1 * (1 - beta), with beta the
    sample's share of negatives; prediction is already a probability,
    clamped to [1e-7, 1 - 1e-7]."""
    label_f = (label > 0.5).to(prediction.dtype)
    num_pos = label_f.sum(dim=(1, 2, 3), keepdim=True)
    num_neg = (1.0 - label_f).sum(dim=(1, 2, 3), keepdim=True)
    beta = num_neg / (num_pos + num_neg).clamp_min(1.0)
    weight = torch.where(label_f > 0.5, beta, 1.1 * (1.0 - beta))
    p = prediction.clamp(1e-7, 1.0 - 1e-7)
    loss = -(label_f * torch.log(p) + (1.0 - label_f) * torch.log(1.0 - p)) * weight
    return loss.sum(dim=(1, 2, 3))
