"""Joint SR + segmentation model (`csbsr_tpu/models/build.py`).

forward(lr, kernel_gt_vec=None, use_gt_kernel=False, clip_sr=False, generator=None) ->
    {"sr": (B, 3, sH, sW), "kernel": (B, k_out^2), "seg": (B, 1, sH, sW), "aux": ...}

`kernel_gt_vec` / `use_gt_kernel` are the GT-kernel window's inputs (KBPN);
`generator` draws the heads' train-mode dropout masks.

SR: KBPN, or DBPN, whose kernel output is zeros in the compute dtype (the
JAX package's, so kernel-PSNR of a DBPN model is that of 0/0, NaN).
Detectors: PSPNet, u-net16, PSPNet_BlurSkip / _origin / Reduct (the kernel
vector conditions the skip ladder; Reduct first resizes the k_out^2 kernel
to KERNEL_SIZE^2, bicubic with align_corners), HRNet_OCR and CrackFormer
(aux = its five side maps). `aux` is None for a head without one (u-net16).
DSRL, SrcNetSR / SegNet, SR_SEG_INV and ONLY_IMAGES raise and wait in
ROADMAP.md, queue 1.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .crackformer import CrackFormer
from .dbpn import DBPN
from .hrnet_ocr import HRNetW48OCR
from .kbpn import KBPN
from .pspnet import PSPNet, PSPNetBlurSkip
from .unet import UNet16
from ..ops.resize import resize
from ..utils.device import compute_dtype, resolve_device, upcast

SEG_RETURNS_AUX = ("PSPNet", "PSPNet_BlurSkip", "PSPNet_BlurSkip_origin",
                   "PSPNet_BlurSkipReduct", "HRNet_OCR", "CrackFormer")
BLURSKIP_TYPES = ("PSPNet_BlurSkip", "PSPNet_BlurSkip_origin", "PSPNet_BlurSkipReduct")
SR_TYPES = ("KBPN", "DBPN")
DETECTOR_TYPES = ("PSPNet", "u-net16", "HRNet_OCR", "CrackFormer") + BLURSKIP_TYPES


def _norm_sr(sr: torch.Tensor, method: str, mean, std) -> torch.Tensor:
    """MetaSRModel.norm_sr: 'all' (dataset mean/std), 'instance' (per image
    and channel, biased variance, eps 1e-5) or '' (none); float32 math
    (float64 for a float64 sr)."""
    if method not in ("all", "instance"):
        return sr
    x = upcast(sr)
    if method == "all":
        m = torch.tensor(mean, dtype=x.dtype, device=sr.device).reshape(1, -1, 1, 1)
        s = torch.tensor(std, dtype=x.dtype, device=sr.device).reshape(1, -1, 1, 1)
        return ((x - m) / s).to(sr.dtype)
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, correction=0)
    return ((x - mu) / torch.sqrt(var + 1e-5)).to(sr.dtype)


class CSBSRModel(nn.Module):
    def __init__(self, sr="KBPN", detector="PSPNet", scale_factor=4, num_stages=4,
                 num_classes=1, estimate_ksize=21, ksize_output=21, kernel_sft=True,
                 residual_learning=True, pixel_shuffle=False, sum_lr_error_pos="HR",
                 zero_pad_kernel=False, up_sample_method="deconv", norm_sr_output="all",
                 input_mean=(0.4741, 0.4937, 0.5048), input_std=(0.1621, 0.1532, 0.1523),
                 pspnet_backend="resnet34", dtype=torch.float32, generator=None):
        super().__init__()
        if sr not in SR_TYPES or detector not in DETECTOR_TYPES or scale_factor == 1:
            raise NotImplementedError(
                f"SR={sr!r} with DETECTOR_TYPE={detector!r} (SCALE_FACTOR {scale_factor}) is "
                f"not ported yet (SR {SR_TYPES}, detectors {DETECTOR_TYPES}); see ROADMAP.md, "
                "queue 1 (rest of the zoo)"
            )
        self.sr, self.detector = sr, detector
        self.estimate_ksize, self.ksize_output = estimate_ksize, ksize_output
        self.norm_sr_output = norm_sr_output
        self.input_mean, self.input_std = tuple(input_mean), tuple(input_std)
        self.dtype = dtype
        g = generator
        if sr == "KBPN":
            self.sr_model = KBPN(
                scale_factor=scale_factor, num_stages=num_stages, estimate_ksize=estimate_ksize,
                ksize_output=ksize_output, kernel_sft=kernel_sft,
                residual_learning=residual_learning, pixel_shuffle=pixel_shuffle,
                sum_lr_error_pos=sum_lr_error_pos, zero_pad_kernel=zero_pad_kernel,
                generator=g,
            )
        else:
            self.sr_model = DBPN(scale_factor=scale_factor, num_stages=num_stages, generator=g)
        if detector == "PSPNet":
            seg = PSPNet(num_classes, pspnet_backend, generator=g)
        elif detector == "u-net16":
            seg = UNet16(num_classes, up_sampling_method=up_sample_method, generator=g)
        elif detector == "HRNet_OCR":
            seg = HRNetW48OCR(num_classes, generator=g)
        elif detector == "CrackFormer":
            seg = CrackFormer(generator=g)
        else:
            reduct = detector == "PSPNet_BlurSkipReduct"
            seg = PSPNetBlurSkip(num_classes, (estimate_ksize if reduct else ksize_output) ** 2,
                                 modify_blur_skip=detector != "PSPNet_BlurSkip_origin",
                                 generator=g)
        self.segmentation_model = seg

    def _condition(self, kernel_vec):
        """The BlurSkip ladder's condition: the kernel vector, for Reduct
        resized to KERNEL_SIZE^2 (bicubic, align_corners=True)."""
        if self.detector != "PSPNet_BlurSkipReduct":
            return kernel_vec
        k_out, k_in = self.ksize_output, self.estimate_ksize
        k2d = kernel_vec.reshape(-1, 1, k_out, k_out)
        return resize(k2d, (k_in, k_in), method="bicubic",
                      align_corners=True).reshape(-1, k_in * k_in)

    def forward(self, x, kernel_gt_vec=None, use_gt_kernel=False, clip_sr: bool = False,
                generator=None):
        if self.sr == "KBPN":
            sr, kernel_vec = self.sr_model(x, kernel_gt_vec, use_gt_kernel,
                                           compute_dtype=self.dtype)
        else:
            sr = self.sr_model(x, compute_dtype=self.dtype)
            kernel_vec = torch.zeros((x.shape[0], self.ksize_output ** 2), dtype=self.dtype,
                                     device=x.device)
        if clip_sr:
            sr = sr.clamp(0.0, 1.0)
        sr_norm = _norm_sr(sr, self.norm_sr_output, self.input_mean, self.input_std)
        seg_in = sr_norm.to(self.dtype)
        if self.detector in BLURSKIP_TYPES:
            seg, aux = self.segmentation_model(seg_in, self._condition(kernel_vec), generator)
        elif self.detector == "u-net16":
            seg, aux = self.segmentation_model(seg_in), None
        else:
            seg, aux = self.segmentation_model(seg_in, generator)
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
        up_sample_method=cfg.MODEL.UP_SAMPLE_METHOD,
        norm_sr_output=cfg.SOLVER.NORM_SR_OUTPUT,
        input_mean=cfg.INPUT.MEAN, input_std=cfg.INPUT.STD,
        pspnet_backend=cfg.TPU.PSPNET_BACKEND,
        dtype=compute_dtype(cfg) if dtype is None else dtype,
        generator=gen,
    )
    return model.to(dev).eval()
