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

Ported branches: every seg loss but CrackFormerLoss, the KBPN/L1/L2 SR
losses, the aux-loss combination (CrackFormer's side maps too), the
oriented weights, the joint/staged combiner and the pretrain-window
overrides. DSRL, SR_SEG_INV, ONLY_IMAGES and SCALE_FACTOR 1 / bicubic SR
raise.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..losses import (bce, bce_dice, binary_dice, boundary_combo_loss, boundary_gdice_loss,
                      boundary_sdf, crack_oriented_exp_weight, crack_oriented_weight,
                      generalized_boundary_combo_loss, kbpn_loss, l1_per_sample, l2_per_sample,
                      segment_failure_oriented_exp_weight, segment_failure_oriented_weight,
                      weighted_bce)

__all__ = ["build_seg_loss", "build_loss_fn"]

_BOUNDARY_LOSSES = ("BoundaryCombo", "Boundary_GDice", "GeneralizedBoundaryCombo")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md, queue 1")


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
    }
    if name == "CrackFormerLoss":
        raise _not_ported("SEG_LOSS_FUNC 'CrackFormerLoss'")
    if name not in losses:
        raise NotImplementedError(name)
    return losses[name], per_pixel


def build_loss_fn(cfg) -> Callable:
    """-> fn(outputs, batch, phase) -> {"total", "seg_loss", "sr_loss"[,
    "kernel_pred_2d"]}, scalars but the kernel.

    batch: {"lr": (B, 3, h, w), "hr": (B, 3, H, W), "seg": (B, 1, H, W),
    "kernel": (B, k, k)}; outputs: the joint model's dict."""
    if cfg.MODEL.SR == "DSRL":
        raise _not_ported("the DSRL loss combiner")
    if cfg.MODEL.SR_SEG_INV:
        raise _not_ported("MODEL.SR_SEG_INV")
    if cfg.DATASET.ONLY_IMAGES:
        raise _not_ported("SR-only pretraining (DATASET.ONLY_IMAGES)")
    if cfg.MODEL.SCALE_FACTOR == 1 or cfg.MODEL.SR in ("bicubic", "none"):
        raise _not_ported("training without an SR network")
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

    def _co_weight(tgt):
        if w_variant == "linear":
            return crack_oriented_weight(tgt, co_sr_amp, co_sr_bias, w_gaus_size, w_gaus_sigma)
        return crack_oriented_exp_weight(tgt, co_sr_amp)

    def _sfo_weight(pred, tgt, amp, bias):
        if w_variant == "linear":
            return segment_failure_oriented_weight(pred, tgt, amp, bias, w_gaus_size, w_gaus_sigma)
        return segment_failure_oriented_exp_weight(pred, tgt, amp)

    def loss_fn(outputs, batch, phase) -> Dict[str, torch.Tensor]:
        it, alpha = phase["iteration"], phase["alpha"]
        acc = torch.float64 if outputs["sr"].dtype == torch.float64 else torch.float32
        seg_preds = outputs["seg"].to(acc)
        seg_targets = batch["seg"].to(acc)

        # segmentation loss, main + aux
        sdf = boundary_sdf(seg_targets) if needs_sdf else None
        seg_loss = seg_loss_fn(seg_preds, seg_targets, alpha, sdf)
        if outputs.get("aux") is not None:
            aux = outputs["aux"].to(acc)
            if side_maps:  # the target and its SDF broadcast to the side maps
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
        if sr_loss_name == "KBPN":
            sr_loss, kernel_2d = kbpn_loss(
                outputs["sr"].to(acc), batch["hr"].to(acc), batch["lr"].to(acc),
                outputs["kernel"].to(acc), batch["kernel"].to(acc), it,
                ksize=ksize_out, scale_factor=sf, weights=kbpn_w,
                only_kernel_loss_in_window=phase["in_kernel_window"] if only_kernel else None,
                segment_preds=seg_preds, segment_targets=seg_targets,
                co_amp=co_sr_amp, sfo_amp=sfo_sr_amp, weight_iter=w_iter,
                co_bias=co_sr_bias, sfo_bias=sfo_sr_bias, weight_variant=w_variant,
                gaus_size=w_gaus_size, gaus_sigma=w_gaus_sigma,
                downscale_method=downscale_method)
        else:
            sr, tgt = outputs["sr"].to(acc), batch["hr"].to(acc)
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
        if phase["in_seg_pretrain"]:
            total = seg_mean
        elif phase["in_sr_pretrain"]:
            total = sr_mean
        elif joint:
            total = (1.0 - phase["w_task"]) * sr_mean + phase["w_task"] * seg_mean
        else:
            total = seg_mean
        out = {"total": total, "seg_loss": seg_mean, "sr_loss": sr_mean}
        if kernel_2d is not None:
            out["kernel_pred_2d"] = kernel_2d
        return out

    return loss_fn
