"""Joint SR + segmentation model (`csbsr_tpu/models/build.py`).

forward(lr, kernel_gt_vec=None, use_gt_kernel=False, clip_sr=False, generator=None,
        sr_targets=None) ->
    {"sr": (B, 3, sH, sW), "kernel": (B, k_out^2), "seg": (B, 1, sH, sW), "aux": ...}

`kernel_gt_vec` / `use_gt_kernel` are the GT-kernel window's inputs (KBPN);
`generator` draws the heads' train-mode dropout masks; `sr_targets` is the
HR image, which SCALE_FACTOR 1 takes as its SR output.

SR: KBPN, or DBPN or SrcNetSR, whose kernel output is zeros in the compute
dtype (the JAX package's, so kernel-PSNR of such a model is that of 0/0,
NaN). Without
an SR network (SCALE_FACTOR 1: the SR output is `sr_targets`; SR "bicubic":
a bicubic resize of the LR) the kernel is zeros too. SR "none" needs
SCALE_FACTOR 1; the JAX package fails on it otherwise, and the port raises
a ValueError.
Detectors: PSPNet, u-net16, PSPNet_BlurSkip / _origin / Reduct (the kernel
vector conditions the skip ladder; Reduct first resizes the k_out^2 kernel
to KERNEL_SIZE^2, bicubic with align_corners), HRNet_OCR, CrackFormer
(aux = its five side maps) and SegNet. `aux` is None for a head without one
(u-net16, SegNet).
`sr_only` (SR-only pretraining, DATASET.ONLY_IMAGES) builds no seg head and
returns seg = aux = None. `sr_seg_inv` (MODEL.SR_SEG_INV) segments the LR
image (un-normalised; a BlurSkip ladder conditioned on the GT kernel
vector), then super-resolves that 1-channel map, which is both "sr" and
"seg"; "lr_seg" is the LR map.

SR and DETECTOR_TYPE both "DSRL" build the parallel model instead
(`parallel_model`, models/dsrl.py, backbone TPU.DSRL_BACKBONE): with
MODEL.DSRL_UPSAMPLE "deconv" its x4 deconv chain gives the outputs at x4;
otherwise the x2 chain, then a resize to x SCALE_FACTOR of the LR
(DSRL_UPSAMPLE's method, align_corners). It adds "fea_seg" and "fea_sr"
(the FA loss's pair) to the outputs; its kernel is zeros, its aux None.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .crackformer import CrackFormer
from .dbpn import DBPN
from .dsrl import DSRL
from .hrnet_ocr import HRNetW48OCR
from .kbpn import KBPN
from .pspnet import PSPNet, PSPNetBlurSkip
from .srcnet import SegNet, SrcNetSR
from .unet import UNet16
from ..ops.resize import resize
from ..utils.device import compute_dtype, resolve_device, upcast

SEG_RETURNS_AUX = ("PSPNet", "PSPNet_BlurSkip", "PSPNet_BlurSkip_origin",
                   "PSPNet_BlurSkipReduct", "HRNet_OCR", "CrackFormer")
BLURSKIP_TYPES = ("PSPNet_BlurSkip", "PSPNet_BlurSkip_origin", "PSPNet_BlurSkipReduct")
SR_TYPES = ("KBPN", "DBPN", "SrcNetSR")
SR_NONE_TYPES = ("bicubic", "none")
DETECTOR_TYPES = ("PSPNet", "u-net16", "HRNet_OCR", "CrackFormer", "SegNet") + BLURSKIP_TYPES


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
                 pspnet_backend="resnet34", sr_seg_inv=False, sr_only=False,
                 dsrl_upsample="bilinear", dsrl_backbone="resnet",
                 dtype=torch.float32, generator=None):
        super().__init__()
        has_sr = scale_factor != 1 and sr != "bicubic"
        self.dsrl = sr == detector == "DSRL"
        if sr == "none" and has_sr:
            raise ValueError(f'MODEL.SR "none" needs MODEL.SCALE_FACTOR 1, not {scale_factor}')
        if not self.dsrl and ((has_sr and sr not in SR_TYPES) or (
                not sr_only and detector not in DETECTOR_TYPES)):
            raise NotImplementedError(
                f"SR={sr!r} with DETECTOR_TYPE={detector!r} (SCALE_FACTOR {scale_factor}) is "
                f"not ported yet (SR {SR_TYPES + SR_NONE_TYPES}, detectors {DETECTOR_TYPES}, "
                "or both DSRL); see ROADMAP.md, queue 1 (rest of the zoo)"
            )
        self.sr, self.detector, self.scale_factor = sr, detector, scale_factor
        self.has_sr, self.sr_seg_inv, self.sr_only = has_sr, sr_seg_inv, sr_only
        self.estimate_ksize, self.ksize_output = estimate_ksize, ksize_output
        self.norm_sr_output = norm_sr_output
        self.input_mean, self.input_std = tuple(input_mean), tuple(input_std)
        self.dtype = dtype
        g = generator
        if self.dsrl:
            self.dsrl_upsample = dsrl_upsample
            self.parallel_model = DSRL(num_classes, 4 if dsrl_upsample == "deconv" else 2,
                                       dsrl_backbone, generator=g)
            return
        channels = 1 if sr_seg_inv else 3
        if has_sr and sr == "KBPN":
            self.sr_model = KBPN(
                scale_factor=scale_factor, num_stages=num_stages, estimate_ksize=estimate_ksize,
                ksize_output=ksize_output, kernel_sft=kernel_sft,
                residual_learning=residual_learning, pixel_shuffle=pixel_shuffle,
                sum_lr_error_pos=sum_lr_error_pos, zero_pad_kernel=zero_pad_kernel,
                num_channels=channels, generator=g,
            )
        elif has_sr and sr == "DBPN":
            self.sr_model = DBPN(scale_factor=scale_factor, num_channels=channels,
                                 num_stages=num_stages, generator=g)
        elif has_sr:
            self.sr_model = SrcNetSR(scale_factor=scale_factor, generator=g)
        if sr_only:
            return
        if detector == "PSPNet":
            seg = PSPNet(num_classes, pspnet_backend, generator=g)
        elif detector == "u-net16":
            seg = UNet16(num_classes, up_sampling_method=up_sample_method, generator=g)
        elif detector == "HRNet_OCR":
            seg = HRNetW48OCR(num_classes, generator=g)
        elif detector == "CrackFormer":
            seg = CrackFormer(generator=g)
        elif detector == "SegNet":
            seg = SegNet(generator=g)
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

    def _forward_sr(self, x, kernel_gt_vec, use_gt_kernel, sr_targets):
        """-> (sr, kernel_vec)."""
        if self.sr == "KBPN" and self.has_sr:
            return self.sr_model(x, kernel_gt_vec, use_gt_kernel, compute_dtype=self.dtype)
        zeros = torch.zeros((x.shape[0], self.ksize_output ** 2), dtype=self.dtype,
                            device=x.device)
        if self.has_sr:
            return self.sr_model(x, compute_dtype=self.dtype), zeros
        if self.scale_factor == 1:
            if sr_targets is None:
                raise ValueError("SCALE_FACTOR 1 takes the HR image as its SR output: "
                                 "pass sr_targets")
            return sr_targets, zeros
        out_hw = (x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor)
        return resize(x, out_hw, method="bicubic"), zeros

    def _forward_ss(self, x, kernel_vec, generator):
        """The seg head on x (cast to the compute dtype) -> (seg, aux)."""
        x = x.to(self.dtype)
        if self.detector in BLURSKIP_TYPES:
            return self.segmentation_model(x, self._condition(kernel_vec), generator)
        if self.detector == "u-net16":
            return self.segmentation_model(x), None
        return self.segmentation_model(x, generator)

    def _forward_dsrl(self, x, clip_sr, generator):
        seg, sr, fea_seg, fea_sr = self.parallel_model(x.to(self.dtype), generator)
        if self.dsrl_upsample != "deconv":
            out_hw = (x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor)
            sr = resize(sr, out_hw, method=self.dsrl_upsample, align_corners=True)
            seg = resize(seg, out_hw, method=self.dsrl_upsample, align_corners=True)
        if clip_sr:
            sr = sr.clamp(0.0, 1.0)
        kernel = torch.zeros((x.shape[0], self.ksize_output ** 2), dtype=self.dtype,
                             device=x.device)
        return {"sr": sr, "kernel": kernel, "seg": seg, "aux": None, "fea_seg": fea_seg,
                "fea_sr": fea_sr}

    def forward(self, x, kernel_gt_vec=None, use_gt_kernel=False, clip_sr: bool = False,
                generator=None, sr_targets=None):
        if self.dsrl:
            return self._forward_dsrl(x, clip_sr, generator)
        if self.sr_seg_inv:
            lr_seg, lr_aux = self._forward_ss(x, kernel_gt_vec, generator)
            seg, kernel_vec = self._forward_sr(lr_seg, kernel_gt_vec, use_gt_kernel, sr_targets)
            if clip_sr:
                seg = seg.clamp(0.0, 1.0)
            return {"sr": seg, "kernel": kernel_vec, "seg": seg, "aux": lr_aux, "lr_seg": lr_seg}
        sr, kernel_vec = self._forward_sr(x, kernel_gt_vec, use_gt_kernel, sr_targets)
        if clip_sr:
            sr = sr.clamp(0.0, 1.0)
        if self.sr_only:
            return {"sr": sr, "kernel": kernel_vec, "seg": None, "aux": None}
        sr_norm = _norm_sr(sr, self.norm_sr_output, self.input_mean, self.input_std)
        seg, aux = self._forward_ss(sr_norm, kernel_vec, generator)
        return {"sr": sr, "kernel": kernel_vec, "seg": seg, "aux": aux}


def model_from_cfg(cfg, device=None, dtype=None, seed=None) -> CSBSRModel:
    """Build the joint model from a config, random-initialised from `seed`
    (default cfg.SEED) with an explicit torch.Generator, in eval mode on
    `device` (CUDA unless the caller asks otherwise). The compute dtype is
    TPU.COMPUTE_DTYPE unless `dtype` is given; params are float32."""
    dev = resolve_device(device)
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
        pspnet_backend=cfg.TPU.PSPNET_BACKEND, sr_seg_inv=bool(cfg.MODEL.SR_SEG_INV),
        sr_only=bool(cfg.DATASET.ONLY_IMAGES),
        dsrl_upsample=cfg.MODEL.DSRL_UPSAMPLE, dsrl_backbone=cfg.TPU.DSRL_BACKBONE,
        dtype=compute_dtype(cfg) if dtype is None else dtype,
        generator=gen,
    )
    return model.to(dev).eval()
