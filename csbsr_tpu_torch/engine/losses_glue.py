"""Loss composition: outputs + batch + phase -> scalar losses
(`csbsr_tpu/engine/losses_glue.py`).

Static choices (which loss, which weights) come from the config when the
function is built; the phase scalars (alpha, beta, the windows) come in at
each call. The loss math runs in float32 (float64 if the outputs are), as in
the JAX package; tensors are NCHW.

The boundary term's SDF is of the target mask alone, which the main and the
aux loss share, so it is computed once per call: two EDTs, two launches of
the min-plus kernel per train step (the JAX package computes it for each of
the two losses). CrackFormer's aux output is its five side maps, scored
against the target broadcast to them and scaled by their count; the SDF of
that broadcast target is the broadcast of the one SDF, so its steps also
launch the kernel twice.

Branches: every seg loss (CrackFormerLoss too), the KBPN/L1/L2 SR losses,
the aux-loss combination (CrackFormer's side maps too), the oriented
weights, the joint/staged combiner and the pretrain-window overrides; and
  - SR-only pretraining (DATASET.ONLY_IMAGES): the KBPN loss (or L1) alone,
    seg_loss 0;
  - the inverse model (MODEL.SR_SEG_INV): the seg loss on the LR map
    against the target resized by DOWNSCALE_INTERPOLATION (the aux maps
    likewise; one SDF of the resized target when they share its size), the
    plain SR loss against the seg target, and staged training on the SR
    loss;
  - no SR network (SCALE_FACTOR 1 or SR bicubic): total = the seg loss,
    without the window overrides (the reference's combiner reaches neither
    branch that applies them), sr_loss 0;
  - DSRL (MODEL.SR "DSRL"): total = DSRL_SR_WEIGHT * sr + DSRL_FA_WEIGHT *
    fa + DSRL_SEG_WEIGHT * seg, the FA loss of the model's (fea_seg,
    fea_sr) pair, also returned as "fa_loss"; the SR-pretrain window's
    total is the SR loss, the seg-pretrain window's the seg loss.
The KBPN SR loss needs a predicted kernel: with DBPN, SrcNetSR or DSRL
(zero kernels) it is 0/0 in both packages, so their recipes use L1 or L2.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..losses import (bce, bce_dice, binary_dice, boundary_combo_loss, boundary_gdice_loss,
                      boundary_sdf, crack_oriented_exp_weight, crack_oriented_weight,
                      cross_entropy_loss_rcf, fa_loss, generalized_boundary_combo_loss, kbpn_loss,
                      l1_per_sample, l2_per_sample,
                      segment_failure_oriented_exp_weight, segment_failure_oriented_weight,
                      weighted_bce)
from ..ops.resize import resize

__all__ = ["build_seg_loss", "build_loss_fn"]

_BOUNDARY_LOSSES = ("BoundaryCombo", "Boundary_GDice", "GeneralizedBoundaryCombo")


def build_seg_loss(cfg):
    """-> (fn(pred, target, alpha, sdf) -> (B,) or (paired, cross), per_pixel)."""
    name = cfg.SOLVER.SEG_LOSS_FUNC
    pos_w = tuple(cfg.SOLVER.BCELOSS_WEIGHT)
    loss_w = tuple(cfg.SOLVER.WB_AND_D_WEIGHT)
    per_pixel = (float(cfg.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SS_AMP) != 0.0
                 or bool(cfg.SOLVER.INTERM_SSLOSSWEGHT4SR))
    losses = {
        "BCE": lambda p, t, a, s: bce(p, t),
        "WeightedBCE": lambda p, t, a, s: weighted_bce(p, t, pos_w),
        "Dice": lambda p, t, a, s: binary_dice(p, t),
        "Combo": lambda p, t, a, s: bce_dice(p, t, pos_w, loss_w),
        "BoundaryCombo": lambda p, t, a, s: boundary_combo_loss(
            p, t, a, pos_w, loss_w, per_pixel=per_pixel, sdf=s),
        "Boundary_GDice": lambda p, t, a, s: boundary_gdice_loss(p, t, a, sdf=s),
        "GeneralizedBoundaryCombo": lambda p, t, a, s: generalized_boundary_combo_loss(
            p, t, a, pos_w, loss_w, sdf=s),
        "CrackFormerLoss": lambda p, t, a, s: cross_entropy_loss_rcf(p, t),
    }
    if name not in losses:
        raise NotImplementedError(name)
    return losses[name], per_pixel


def build_loss_fn(cfg) -> Callable:
    """-> fn(outputs, batch, phase) -> {"total", "seg_loss", "sr_loss"[,
    "kernel_pred_2d" | "fa_loss"]}, scalars but the kernel.

    batch: {"lr": (B, 3, h, w), "hr": (B, 3, H, W), "seg": (B, 1, H, W),
    "kernel": (B, k, k)}; outputs: the joint model's dict."""
    seg_loss_fn, seg_per_pixel = build_seg_loss(cfg)
    needs_sdf = cfg.SOLVER.SEG_LOSS_FUNC in _BOUNDARY_LOSSES
    aux_w = float(cfg.SOLVER.SEG_AUX_LOSS_WEIGHT)
    main_w = float(cfg.SOLVER.SEG_MAIN_LOSS_WEIGHT)
    sr_loss_name = cfg.SOLVER.SR_LOSS_FUNC
    kbpn_w = tuple(cfg.SOLVER.SR_LOSS_FUNC_SR_WEIGHT)
    ksize_out = int(cfg.BLUR.KERNEL_SIZE_OUTPUT)
    sf = int(cfg.MODEL.SCALE_FACTOR)
    only_kernel = bool(cfg.SOLVER.ONLY_KERNEL_LOSS_FOR_PRETRAIN)
    co_sr_amp = float(cfg.SOLVER.CRACK_ORIENTED_WEIGHT4SR_AMP)
    sfo_sr_amp = float(cfg.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SR_AMP)
    sfo_ss_amp = float(cfg.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SS_AMP)
    co_sr_bias = float(cfg.SOLVER.CRACK_ORIENTED_WEIGHT4SR_BIAS)
    sfo_sr_bias = float(cfg.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SR_BIAS)
    sfo_ss_bias = float(cfg.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SS_BIAS)
    w_variant = str(cfg.TPU.ORIENTED_WEIGHT_VARIANT)
    w_gaus_sigma = float(cfg.SOLVER.ORIENTED_WEIGHT_GAUS)
    w_gaus_size = int(cfg.BLUR.KERNEL_SIZE)
    w_iter = int(cfg.SOLVER.ORIENTED_WEIGHT_ITER)
    interm_ss4sr = bool(cfg.SOLVER.INTERM_SSLOSSWEGHT4SR)
    joint = bool(cfg.MODEL.JOINT_LEARNING)
    downscale_method = cfg.SOLVER.DOWNSCALE_INTERPOLATION
    side_maps = cfg.MODEL.DETECTOR_TYPE == "CrackFormer"
    sr_none = cfg.MODEL.SCALE_FACTOR == 1 or cfg.MODEL.SR == "bicubic"
    sr_seg_inv = bool(cfg.MODEL.SR_SEG_INV)
    sr_only = bool(cfg.DATASET.ONLY_IMAGES)
    dsrl_w = (float(cfg.SOLVER.DSRL_SR_WEIGHT), float(cfg.SOLVER.DSRL_FA_WEIGHT),
              float(cfg.SOLVER.DSRL_SEG_WEIGHT)) if cfg.MODEL.SR == "DSRL" else None

    def _co_weight(tgt):
        if w_variant == "linear":
            return crack_oriented_weight(tgt, co_sr_amp, co_sr_bias, w_gaus_size, w_gaus_sigma)
        return crack_oriented_exp_weight(tgt, co_sr_amp)

    def _sfo_weight(pred, tgt, amp, bias):
        if w_variant == "linear":
            return segment_failure_oriented_weight(pred, tgt, amp, bias, w_gaus_size, w_gaus_sigma)
        return segment_failure_oriented_exp_weight(pred, tgt, amp)

    def kbpn(outputs, batch, phase, acc, **oriented):
        return kbpn_loss(
            outputs["sr"].to(acc), batch["hr"].to(acc), batch["lr"].to(acc),
            outputs["kernel"].to(acc), batch["kernel"].to(acc), phase["iteration"],
            ksize=ksize_out, scale_factor=sf, weights=kbpn_w,
            only_kernel_loss_in_window=phase["in_kernel_window"] if only_kernel else None,
            downscale_method=downscale_method, **oriented)

    def sr_only_loss(outputs, batch, phase, acc):
        if sr_loss_name == "KBPN":
            sr_loss = kbpn(outputs, batch, phase, acc)[0]
        else:
            sr_loss = l1_per_sample(outputs["sr"].to(acc), batch["hr"].to(acc))
        sr_mean = sr_loss.mean()
        return {"total": sr_mean, "seg_loss": torch.zeros((), dtype=acc, device=sr_mean.device),
                "sr_loss": sr_mean}

    def loss_fn(outputs, batch, phase) -> Dict[str, torch.Tensor]:
        it, alpha = phase["iteration"], phase["alpha"]
        acc = torch.float64 if outputs["sr"].dtype == torch.float64 else torch.float32
        if sr_only:
            return sr_only_loss(outputs, batch, phase, acc)
        seg_preds = outputs["seg"].to(acc)
        seg_targets = batch["seg"].to(acc)

        # segmentation loss, main + aux
        if sr_seg_inv:  # on the LR map, against the target resized to it
            main_pred = outputs["lr_seg"].to(acc)
            main_tgt = resize(seg_targets, main_pred.shape[-2:], method=downscale_method)
        else:
            main_pred, main_tgt = seg_preds, seg_targets
        sdf = boundary_sdf(main_tgt) if needs_sdf else None
        seg_loss = seg_loss_fn(main_pred, main_tgt, alpha, sdf)
        if outputs.get("aux") is not None:
            aux = outputs["aux"].to(acc)
            if sr_seg_inv:
                aux_tgt = resize(seg_targets, aux.shape[-2:], method=downscale_method)
                if sdf is not None and aux_tgt.shape != main_tgt.shape:
                    sdf = boundary_sdf(aux_tgt)
                aux_loss = seg_loss_fn(aux, aux_tgt, alpha, sdf)
            elif side_maps:  # the target and its SDF broadcast to the side maps
                n = aux.shape[1]
                aux_loss = seg_loss_fn(aux, seg_targets.expand_as(aux), alpha,
                                       None if sdf is None else sdf.expand_as(aux))
                aux_loss = tuple(n * a for a in aux_loss) if seg_per_pixel else n * aux_loss
            else:
                aux_loss = seg_loss_fn(aux, seg_targets, alpha, sdf)
            if seg_per_pixel:  # (paired, cross) pairs, combined factor by factor
                seg_loss = tuple(main_w * m + aux_w * a for m, a in zip(seg_loss, aux_loss))
            else:
                seg_loss = main_w * seg_loss + aux_w * aux_loss

        # SR loss
        kernel_2d = None
        if sr_none:
            sr_loss = torch.zeros((seg_preds.shape[0],), dtype=acc, device=seg_preds.device)
        elif sr_loss_name == "KBPN":
            sr_loss, kernel_2d = kbpn(
                outputs, batch, phase, acc, segment_preds=seg_preds,
                segment_targets=seg_targets, co_amp=co_sr_amp, sfo_amp=sfo_sr_amp,
                weight_iter=w_iter, co_bias=co_sr_bias, sfo_bias=sfo_sr_bias,
                weight_variant=w_variant, gaus_size=w_gaus_size, gaus_sigma=w_gaus_sigma)
        else:
            sr, tgt = outputs["sr"].to(acc), batch["seg" if sr_seg_inv else "hr"].to(acc)
            sr_loss = (l1_per_sample if sr_loss_name == "L1" else l2_per_sample)(sr, tgt)
            # the reference's multiple_weight for the plain SR losses
            if (co_sr_amp != 0.0 or sfo_sr_amp != 0.0) and it >= w_iter:
                per_map = (sr - tgt).abs()
                if co_sr_amp != 0.0:
                    per_map = _co_weight(seg_targets) * per_map
                if sfo_sr_amp != 0.0:
                    per_map = _sfo_weight(seg_preds, seg_targets, sfo_sr_amp, sfo_sr_bias) * per_map
                sr_loss = per_map.mean(dim=(1, 2, 3))

        # per-pixel mode: map[i, j] = paired[i] + cross[j], optionally
        # failure-weighted per sample i; reduced without building B^2 maps
        if seg_per_pixel:
            paired, cross = seg_loss
            if sfo_ss_amp != 0.0 and it >= w_iter:
                w = _sfo_weight(seg_preds, seg_targets, sfo_ss_amp, sfo_ss_bias)
                seg_loss = (w * (paired + cross.mean(dim=0, keepdim=True))).mean(dim=(1, 2, 3))
            else:
                seg_loss = (paired + cross).mean(dim=(1, 2, 3))

        if interm_ss4sr:
            sr_loss = seg_loss.detach().mean() * sr_loss

        seg_mean, sr_mean = seg_loss.mean(), sr_loss.mean()
        if dsrl_w is not None:
            fa = fa_loss(outputs["fea_seg"].to(acc), outputs["fea_sr"].to(acc))
            if phase["in_seg_pretrain"]:
                total = seg_mean
            elif phase["in_sr_pretrain"]:
                total = sr_mean
            else:
                total = dsrl_w[0] * sr_mean + dsrl_w[1] * fa + dsrl_w[2] * seg_mean
            return {"total": total, "seg_loss": seg_mean, "sr_loss": sr_mean, "fa_loss": fa}
        if sr_none or phase["in_seg_pretrain"]:
            total = seg_mean
        elif phase["in_sr_pretrain"]:
            total = sr_mean
        elif joint:
            # 1 - w_task in float32, as the JAX package forms it
            total = float(np.float32(1.0 - phase["w_task"])) * sr_mean + phase["w_task"] * seg_mean
        else:
            total = sr_mean if sr_seg_inv else seg_mean
        out = {"total": total, "seg_loss": seg_mean, "sr_loss": sr_mean}
        if kernel_2d is not None:
            out["kernel_pred_2d"] = kernel_2d
        return out

    return loss_fn
