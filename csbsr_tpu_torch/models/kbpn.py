"""KBPN, the kernelized back-projection SR network (`csbsr_tpu/models/kbpn.py`).

This is the reference math: dense channel concats and a materialised
kernel-condition map, which is what `CSBSR_MERGED_SR=0` / `CSBSR_DENSE_IKC=1`
select in the JAX package (its default merged / banded forms are XLA
restructurings with identical math and param layout). Only the flagship
variant is ported: SUM_LR_ERROR_POS=HR, no pixel shuffle, kernel SFT on,
bicubic kernel upsampling (ZERO_PAD_KERNEL=False), 3 channels.

Blur kernels flow as (B, k_out^2) vectors and stay float32 (float64 in a
float64 run); the feature maps run in the input's compute dtype. Tensors are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvBlock, DeconvBlock, SFTLayer, conv2d
from ..ops.blur import batch_blur
from ..ops.resize import resize
from ..utils.device import upcast

_CONV_SETTING = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


def normalize_kernel_vec(vec: torch.Tensor) -> torch.Tensor:
    """vec / vec.sum(-1), the sum-1 renormalisation. vec: (B, k^2)."""
    return vec / vec.sum(dim=-1, keepdim=True)


def _resize_kernel_vec(vec: torch.Tensor, k_in: int, k_out: int) -> torch.Tensor:
    """(B, k_in^2) -> bicubic -> (B, k_out^2), float32 (float64 for a
    float64 vec)."""
    k2d = upcast(vec).reshape(-1, 1, k_in, k_in)
    return resize(k2d, (k_out, k_out), method="bicubic").reshape(-1, k_out * k_out)


class PredictorWithGAP(nn.Module):
    """Initial kernel predictor: 3 ConvBlocks (prelu 0.01, no norm, no bias)
    -> GAP -> bicubic resize to the output size when it differs -> sum-1."""

    def __init__(self, in_ch, input_ch, estimate_ksize, ksize_output, generator=None):
        super().__init__()
        self.estimate_ksize, self.ksize_output = estimate_ksize, ksize_output
        chans = [in_ch, input_ch, input_ch, estimate_ksize**2]
        self.feat_ext = nn.Sequential(*[
            ConvBlock(chans[i], chans[i + 1], 3, 1, 1, activation="prelu",
                      generator=generator)
            for i in range(3)
        ])

    def forward(self, x):
        vec = upcast(self.feat_ext(x)).mean(dim=(2, 3))
        if self.ksize_output != self.estimate_ksize:
            vec = _resize_kernel_vec(vec, self.estimate_ksize, self.ksize_output)
        return normalize_kernel_vec(vec)


class KernelPredictorLikeIKC(nn.Module):
    """IKC-style kernel refiner: delta = GAP(convs(cat(feats(SR),
    feats(kernel map)))), returns prev_kernel + upsampled delta."""

    def __init__(self, estimate_ksize, ksize_output, generator=None):
        super().__init__()
        self.estimate_ksize, self.ksize_output = estimate_ksize, ksize_output
        kc, red, cond = estimate_ksize**2, 32, ksize_output**2
        cb = lambda i, o, k, p, act: ConvBlock(i, o, k, 1, p, activation=act,
                                               generator=generator)
        self.fe_SR = nn.Sequential(
            cb(3, kc, 3, 1, "relu"), cb(kc, red, 1, 0, "lrelu"), cb(red, red, 3, 1, "lrelu"),
            cb(red, red, 3, 1, "lrelu"), cb(red, kc, 3, 1, "lrelu"),
        )
        self.fe_kernel = nn.Sequential(cb(cond, kc, 3, 1, "lrelu"), cb(kc, kc, 3, 1, "lrelu"))
        self.fe_cat = nn.Sequential(
            cb(2 * kc, red, 1, 0, "lrelu"), cb(red, red, 3, 1, "lrelu"),
            cb(red, kc, 3, 1, None),
        )

    def forward(self, sr, pre_kernel_vec):
        fsr = self.fe_SR(sr)
        b, _, h, w = sr.shape
        cond = pre_kernel_vec.to(fsr.dtype)[:, :, None, None].expand(b, -1, h, w)
        fh = self.fe_kernel(cond)
        delta = upcast(self.fe_cat(torch.cat([fsr, fh], dim=1))).mean(dim=(2, 3))
        if self.ksize_output != self.estimate_ksize:
            delta = _resize_kernel_vec(delta, self.estimate_ksize, self.ksize_output)
        return pre_kernel_vec + delta


def _prelu_block(cls, i, o, k, s, p, bias=False, generator=None):
    return cls(i, o, k, s, p, bias=bias, activation="prelu", generator=generator)


class KBPNUpBlock(nn.Module):
    """1x1 merge conv (bias, prelu) -> deconv -> conv -> deconv(error)."""

    def __init__(self, in_ch, num_filter, k, s, p, generator=None):
        super().__init__()
        g = generator
        self.conv = _prelu_block(ConvBlock, in_ch, num_filter, 1, 1, 0, bias=True, generator=g)
        self.up_conv1 = _prelu_block(DeconvBlock, num_filter, num_filter, k, s, p, generator=g)
        self.up_conv2 = _prelu_block(ConvBlock, num_filter, num_filter, k, s, p, generator=g)
        self.up_conv3 = _prelu_block(DeconvBlock, num_filter, num_filter, k, s, p, generator=g)

    def forward(self, x):
        x = self.conv(x)
        h0 = self.up_conv1(x)
        l0 = self.up_conv2(h0)
        h1 = self.up_conv3(l0 - x)
        return h1 + h0


class KBPNDownBlock(nn.Module):
    """1x1 stage-merge conv (bias, prelu) -> conv -> deconv -> conv(error)."""

    def __init__(self, in_ch, num_filter, k, s, p, generator=None):
        super().__init__()
        g = generator
        self.conv = _prelu_block(ConvBlock, in_ch, num_filter, 1, 1, 0, bias=True, generator=g)
        self.down_conv1 = _prelu_block(ConvBlock, num_filter, num_filter, k, s, p, generator=g)
        self.down_conv2 = _prelu_block(DeconvBlock, num_filter, num_filter, k, s, p, generator=g)
        self.down_conv3 = _prelu_block(ConvBlock, num_filter, num_filter, k, s, p, generator=g)

    def forward(self, x):
        x = self.conv(x)
        l0 = self.down_conv1(x)
        h0 = self.down_conv2(l0)
        l1 = self.down_conv3(h0 - x)
        return l1 + l0


class SFTLayerKBPN(SFTLayer):
    """The SFT layer with the kernel vector broadcast to the condition map."""

    def forward(self, features, kernel_vec):
        b, _, h, w = features.shape
        cond = kernel_vec.to(features.dtype)[:, :, None, None].expand(b, -1, h, w)
        return super().forward(features, cond)


class KBlock(nn.Module):
    """Kernel back-projection block, HR error mode: sr_t = sr_reconst(cat(hs));
    refine the kernel (IKC) unless `use_gt_kernel`; pseudo-LR = sr_t blurred by the normalised
    kernel at stride SF; back-project the LR error through a deconv."""

    def __init__(self, num_filter, k, s, p, stage, estimate_ksize, ksize_output,
                 scale_factor, generator=None):
        super().__init__()
        g = generator
        self.ksize_output, self.scale_factor = ksize_output, scale_factor
        self.sr_reconst = ConvBlock(stage * num_filter, 3, 3, 1, 1, activation=None,
                                    generator=g)
        self.kernel_predictor = KernelPredictorLikeIKC(estimate_ksize, ksize_output, generator=g)
        self.up_conv1 = _prelu_block(DeconvBlock, 3, num_filter, k, s, p, generator=g)

    def forward(self, concat_h, h, input_lr, kernel_vec, use_gt_kernel):
        sr_t = self.sr_reconst(concat_h)
        refined = self.kernel_predictor(sr_t, kernel_vec)
        # the GT-kernel window keeps the incoming kernel (reference kbpn.py:386-388)
        kernel_vec = torch.where(use_gt_kernel, kernel_vec, refined)
        vec = normalize_kernel_vec(kernel_vec)
        weight = vec.reshape(-1, self.ksize_output, self.ksize_output)
        pseudo_lr = batch_blur(sr_t, weight, stride=self.scale_factor)
        error = pseudo_lr - input_lr.to(pseudo_lr.dtype)
        return h + self.up_conv1(error), vec


class KBPNStage(nn.Module):
    """One back-projection stage: `up`, `kb` and, except for the last stage,
    `down` and `sft` (the reference's back_projection_stages entries)."""

    def __init__(self, stage, final, in_ch, md, k, s, p, estimate_ksize, ksize_output,
                 scale_factor, generator=None):
        super().__init__()
        g = generator
        self.up = KBPNUpBlock(in_ch, md, k, s, p, generator=g)
        self.kb = KBlock(md, k, s, p, stage, estimate_ksize, ksize_output, scale_factor,
                         generator=g)
        if not final:
            self.down = KBPNDownBlock(stage * md, md, k, s, p, generator=g)
            self.sft = SFTLayerKBPN(stage * md, ksize_output**2, generator=g)


class KBPN(nn.Module):
    """Dense KBPN. forward(lr, kernel_gt_vec=None, use_gt_kernel=False) ->
    (sr, kernel_vec), with kernel_vec the normalised (B, k_out^2) kernel.

    `use_gt_kernel` is the GT-kernel window's flag (a bool or a 0-d bool
    tensor): where it is set, the GT kernel replaces the predicted one and
    every stage keeps it instead of the IKC-refined kernel. Both branches are
    computed and one is selected with `torch.where`, as in the JAX package,
    so one code path serves every phase."""

    def __init__(self, scale_factor=4, num_stages=4, md_ch=128, estimate_ksize=21,
                 ksize_output=21, kernel_sft=True, residual_learning=True,
                 pixel_shuffle=False, sum_lr_error_pos="HR", zero_pad_kernel=False,
                 generator=None):
        super().__init__()
        if pixel_shuffle or sum_lr_error_pos != "HR" or zero_pad_kernel or not kernel_sft:
            raise NotImplementedError(
                "only the flagship KBPN variant is ported (SUM_LR_ERROR_POS=HR, "
                "SR_PIXEL_SHUFFLE=False, KBPN_KERNEL_SFT=True, ZERO_PAD_KERNEL=False); "
                "see ROADMAP.md, queue 1"
            )
        g = generator
        k, s, p = _CONV_SETTING[scale_factor]
        self.scale_factor, self.num_stages = scale_factor, num_stages
        self.residual_learning = residual_learning
        chans = [3, 64, 64, 128, 128]
        layers = []
        for i in range(4):
            layers += [conv2d(chans[i], chans[i + 1], 3, padding=1, generator=g), nn.ReLU()]
        self.feat = nn.Sequential(*layers)
        self.predictor = PredictorWithGAP(128, md_ch, estimate_ksize, ksize_output, generator=g)
        self.back_projection_stages = nn.ModuleList([
            KBPNStage(st, st == num_stages, 128 if st == 1 else (st - 1) * md_ch, md_ch,
                      k, s, p, estimate_ksize, ksize_output, scale_factor, generator=g)
            for st in range(1, num_stages + 1)
        ])
        self.output_conv = ConvBlock(num_stages * md_ch, 3, 3, 1, 1, activation=None,
                                     generator=g)

    def forward(self, x: torch.Tensor, kernel_gt_vec=None, use_gt_kernel=False,
                compute_dtype: torch.dtype = torch.float32):
        use_gt = use_gt_kernel
        if not isinstance(use_gt, torch.Tensor):  # a fill, not a host-to-device copy
            use_gt = torch.full((), bool(use_gt), dtype=torch.bool, device=x.device)
        low = self.feat(x.to(compute_dtype))
        kernel_vec = self.predictor(low)
        if kernel_gt_vec is not None:
            kernel_vec = torch.where(use_gt, kernel_gt_vec.to(kernel_vec.dtype), kernel_vec)
        hs, lows = [], []
        for st, stage in enumerate(self.back_projection_stages, start=1):
            h = stage.up(low)
            h, kernel_vec = stage.kb(torch.cat(hs + [h], dim=1), h, x, kernel_vec, use_gt)
            hs.append(h)
            if st < self.num_stages:
                lows.append(stage.down(torch.cat(hs, dim=1)))
                low = stage.sft(torch.cat(lows, dim=1), kernel_vec)
        sr = self.output_conv(torch.cat(hs, dim=1))
        if self.residual_learning:
            out_hw = (x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor)
            sr = sr + resize(x, out_hw, method="bicubic").to(sr.dtype)
        return sr, kernel_vec
