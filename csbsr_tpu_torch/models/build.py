"""Joint SR + segmentation model (`csbsr_tpu/models/build.py`).

forward(lr, clip_sr=False) ->
    {"sr": (B, 3, sH, sW), "kernel": (B, k_out^2), "seg": (B, 1, sH, sW), "aux": ...}

Only SR=KBPN with DETECTOR_TYPE=PSPNet is ported; the rest of the zoo waits
in ROADMAP.md, queue 1.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .kbpn import KBPN
from .pspnet import PSPNet
from ..utils.device import compute_dtype, resolve_device


def _norm_sr(sr: torch.Tensor, method: str, mean, std) -> torch.Tensor:
    """MetaSRModel.norm_sr: 'all' (dataset mean/std), 'instance' (per image
    and channel, biased variance, eps 1e-5) or '' (none); float32 math."""
    if method == "all":
        m = torch.tensor(mean, dtype=torch.float32, device=sr.device).reshape(1, -1, 1, 1)
        s = torch.tensor(std, dtype=torch.float32, device=sr.device).reshape(1, -1, 1, 1)
        return ((sr.float() - m) / s).to(sr.dtype)
    if method == "instance":
        x = sr.float()
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, correction=0)
        return ((x - mu) / torch.sqrt(var + 1e-5)).to(sr.dtype)
    return sr


class CSBSRModel(nn.Module):
    def __init__(self, sr="KBPN", detector="PSPNet", scale_factor=4, num_stages=4,
                 num_classes=1, estimate_ksize=21, ksize_output=21, kernel_sft=True,
                 residual_learning=True, pixel_shuffle=False, sum_lr_error_pos="HR",
                 zero_pad_kernel=False, norm_sr_output="all",
                 input_mean=(0.4741, 0.4937, 0.5048), input_std=(0.1621, 0.1532, 0.1523),
                 pspnet_backend="resnet34", dtype=torch.float32, generator=None):
        super().__init__()
        if sr != "KBPN" or detector != "PSPNet" or scale_factor == 1:
            raise NotImplementedError(
                f"SR={sr!r} with DETECTOR_TYPE={detector!r} is not ported yet "
                "(KBPN + PSPNet only); see ROADMAP.md, queue 1 (rest of the zoo)"
            )
        self.ksize_output = ksize_output
        self.norm_sr_output = norm_sr_output
        self.input_mean, self.input_std = tuple(input_mean), tuple(input_std)
        self.dtype = dtype
        self.sr_model = KBPN(
            scale_factor=scale_factor, num_stages=num_stages, estimate_ksize=estimate_ksize,
            ksize_output=ksize_output, kernel_sft=kernel_sft,
            residual_learning=residual_learning, pixel_shuffle=pixel_shuffle,
            sum_lr_error_pos=sum_lr_error_pos, zero_pad_kernel=zero_pad_kernel,
            generator=generator,
        )
        self.segmentation_model = PSPNet(num_classes, pspnet_backend, generator=generator)

    def forward(self, x, clip_sr: bool = False):
        sr, kernel_vec = self.sr_model(x, compute_dtype=self.dtype)
        if clip_sr:
            sr = sr.clamp(0.0, 1.0)
        sr_norm = _norm_sr(sr, self.norm_sr_output, self.input_mean, self.input_std)
        seg, aux = self.segmentation_model(sr_norm.to(self.dtype))
        return {"sr": sr, "kernel": kernel_vec, "seg": seg, "aux": aux}


def model_from_cfg(cfg, device=None, dtype=None, seed=None) -> CSBSRModel:
    """Build the joint model from a config, random-initialised from `seed`
    (default cfg.SEED) with an explicit torch.Generator, in eval mode on
    `device` (CUDA unless the caller asks otherwise). The compute dtype is
    TPU.COMPUTE_DTYPE unless `dtype` is given; params are float32."""
    dev = resolve_device(device)
    if cfg.MODEL.SR_SEG_INV or cfg.DATASET.ONLY_IMAGES:
        raise NotImplementedError(
            "SR_SEG_INV / ONLY_IMAGES models are not ported yet; see ROADMAP.md, queue 1")
    gen = torch.Generator().manual_seed(int(cfg.SEED if seed is None else seed))
    model = CSBSRModel(
        sr=cfg.MODEL.SR, detector=cfg.MODEL.DETECTOR_TYPE,
        scale_factor=cfg.MODEL.SCALE_FACTOR, num_stages=cfg.MODEL.NUM_STAGES,
        num_classes=cfg.MODEL.NUM_CLASSES, estimate_ksize=cfg.BLUR.KERNEL_SIZE,
        ksize_output=cfg.BLUR.KERNEL_SIZE_OUTPUT, kernel_sft=cfg.MODEL.KBPN_KERNEL_SFT,
        residual_learning=cfg.MODEL.SR_RESIDUAL_LEARNING,
        pixel_shuffle=cfg.MODEL.SR_PIXEL_SHUFFLE,
        sum_lr_error_pos=cfg.MODEL.SUM_LR_ERROR_POS,
        zero_pad_kernel=cfg.MODEL.ZERO_PAD_KERNEL,
        norm_sr_output=cfg.SOLVER.NORM_SR_OUTPUT,
        input_mean=cfg.INPUT.MEAN, input_std=cfg.INPUT.STD,
        pspnet_backend=cfg.TPU.PSPNET_BACKEND,
        dtype=compute_dtype(cfg) if dtype is None else dtype,
        generator=gen,
    )
    return model.to(dev).eval()
