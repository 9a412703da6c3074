"""HRNetV2 + OCR segmentation head (`csbsr_tpu/models/hrnet_ocr.py`).

Backbone: stem (two stride-2 3x3 convs) -> layer1 (4 Bottlenecks of 64) ->
three multi-resolution stages of HighResolutionModules with SUM fusion
(branch widths w, 2w, 4w, 8w; 1 / 4 / 3 modules; 4 BasicBlocks per branch).
OCR head: the four branch maps upsampled to 1/4 and concatenated (15w
channels, 720 at W48) -> aux head -> SpatialGather -> SpatialOCR -> 1x1
cls head; both outputs upsampled to the input size, then sigmoid.

With the JAX package's semantics:
  - every bilinear resize uses align_corners=True;
  - SpatialGather's softmax over space is of the *pre-sigmoid* aux map;
  - ObjectAttention runs its key/value convs and BatchNorms on the
    (B, C, 1, K) proxy map, so in train mode their statistics come from B*K
    values;
  - SpatialOCR's Dropout(0.05) acts in train mode, with the step's generator.

`width` (48 for the shipped net) is a constructor argument. Torch names are
the reference's (backbone.stage<s>.<m>.branches / fuse_layers,
transition<t>, aux_head, conv3x3, ocr_distri_head.object_context_block,
cls_head). Tensors are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm2d, Dropout, conv2d
from ..ops.resize import resize


def hrnet_stages(width: int):
    """Branch widths (w, 2w, 4w, 8w), modules 1/4/3, 4 BasicBlocks per branch."""
    return {
        "stage2": dict(num_modules=1, channels=(width, width * 2)),
        "stage3": dict(num_modules=4, channels=(width, width * 2, width * 4)),
        "stage4": dict(num_modules=3, channels=(width, width * 2, width * 4, width * 8)),
    }


def _up(x, hw):
    return resize(x, hw, method="bilinear", align_corners=True)


def _conv_bn(in_ch, out_ch, k, s, g, relu=True):
    """Sequential(conv (no bias), BN[, ReLU])."""
    mods = [conv2d(in_ch, out_ch, k, s, (k - 1) // 2, bias=False, generator=g),
            BatchNorm2d(out_ch)]
    return nn.Sequential(*(mods + [nn.ReLU()] if relu else mods))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, planes, stride=1, generator=None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(in_ch, planes, 3, stride, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, bias=False, generator=g)
        self.bn2 = BatchNorm2d(planes)
        if stride != 1 or in_ch != planes:
            self.downsample = _conv_bn(in_ch, planes, 1, stride, g, relu=False)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch, planes, stride=1, generator=None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(in_ch, planes, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, 1, bias=False, generator=g)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv2d(planes, planes * 4, 1, bias=False, generator=g)
        self.bn3 = BatchNorm2d(planes * 4)
        if stride != 1 or in_ch != planes * 4:
            self.downsample = _conv_bn(in_ch, planes * 4, 1, stride, g, relu=False)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + res)


class HighResolutionModule(nn.Module):
    """Parallel branches of BasicBlocks, then SUM fusion: branch j > i by a
    1x1 conv + BN and a bilinear upsample, j < i by (i - j) strided 3x3 convs
    + BN (ReLU between them), then ReLU."""

    def __init__(self, channels, num_blocks=4, generator=None):
        super().__init__()
        g, n = generator, len(channels)
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c, c, generator=g) for _ in range(num_blocks)])
            for c in channels])
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1, 1, g, relu=False))
                elif j == i:
                    row.append(nn.Identity())
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j], 3,
                                 2, g, relu=k != i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                t = layer(outs[j])
                if j > i:
                    t = _up(t, outs[i].shape[2:])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


def _transition(pre_channels, cur_channels, g):
    """New branches from the last one by stride-2 convs; a width change of
    an existing branch by a 3x3 conv; identities elsewhere."""
    layers = []
    npre = len(pre_channels)
    for i, ch in enumerate(cur_channels):
        if i < npre:
            layers.append(_conv_bn(pre_channels[i], ch, 3, 1, g) if pre_channels[i] != ch
                          else nn.Identity())
        else:
            chain, c_in = [], pre_channels[-1]
            for j in range(i + 1 - npre):
                c_out = ch if j == i - npre else c_in
                chain.append(_conv_bn(c_in, c_out, 3, 2, g))
                c_in = c_out
            layers.append(nn.Sequential(*chain))
    return nn.ModuleList(layers)


class HRNetW48Backbone(nn.Module):
    """forward(x) -> the four branch maps at /4, /8, /16, /32."""

    def __init__(self, width=48, generator=None):
        super().__init__()
        g = generator
        stages = hrnet_stages(width)
        self.conv1 = conv2d(3, 64, 3, 2, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv2d(64, 64, 3, 2, 1, bias=False, generator=g)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if b == 0 else 256, 64, generator=g)
                                      for b in range(4)])
        pre = [256]
        for t, s in enumerate(("stage2", "stage3", "stage4"), start=1):
            chans = stages[s]["channels"]
            setattr(self, f"transition{t}", _transition(pre, chans, g))
            setattr(self, s, nn.ModuleList([HighResolutionModule(chans, generator=g)
                                            for _ in range(stages[s]["num_modules"])]))
            pre = list(chans)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for t, s in enumerate(("stage2", "stage3", "stage4"), start=1):
            trans = getattr(self, f"transition{t}")
            xs = [layer(xs[i] if i < len(xs) else xs[-1]) for i, layer in enumerate(trans)]
            for module in getattr(self, s):
                xs = module(xs)
        return xs


def spatial_gather(feats, probs):
    """Class context: softmax over space of `probs` (B, K, H, W), the
    pre-sigmoid aux map, weighting feats (B, C, H, W) -> (B, K, C)."""
    b, k = probs.shape[:2]
    p = torch.softmax(probs.reshape(b, k, -1), dim=-1)
    return torch.einsum("bkn,bcn->bkc", p, feats.reshape(b, feats.shape[1], -1))


def _conv_bn_relu_seq(in_ch, out_ch, g, twice=False):
    """Sequential(conv, BNReLU[, conv, BNReLU]) with BNReLU = Sequential(BN,
    ReLU): keys <i>.weight for conv i and <i>.0.* for its BN."""
    mods = [conv2d(in_ch, out_ch, 1, generator=g), nn.Sequential(BatchNorm2d(out_ch), nn.ReLU())]
    if twice:
        mods += [conv2d(out_ch, out_ch, 1, generator=g),
                 nn.Sequential(BatchNorm2d(out_ch), nn.ReLU())]
    return nn.Sequential(*mods)


class ObjectAttention(nn.Module):
    """Pixel-to-object attention (scale 1): queries from the pixels, keys
    and values from the (B, C, 1, K) proxy map."""

    def __init__(self, in_ch, key_channels, generator=None):
        super().__init__()
        g, kc = generator, key_channels
        self.key_channels = kc
        self.f_pixel = _conv_bn_relu_seq(in_ch, kc, g, twice=True)
        self.f_object = _conv_bn_relu_seq(in_ch, kc, g, twice=True)
        self.f_down = _conv_bn_relu_seq(in_ch, kc, g)
        self.f_up = _conv_bn_relu_seq(kc, in_ch, g)

    def forward(self, x, proxy):
        b, _, h, w = x.shape
        kc = self.key_channels
        query = self.f_pixel(x).reshape(b, kc, h * w)
        proxy_map = proxy.transpose(1, 2)[:, :, None, :]  # (B, C, 1, K)
        key = self.f_object(proxy_map)[:, :, 0]  # (B, kc, K)
        value = self.f_down(proxy_map)[:, :, 0]
        sim = torch.softmax(torch.einsum("bcn,bck->bnk", query, key) * kc ** -0.5, dim=-1)
        context = torch.einsum("bnk,bck->bcn", sim, value).reshape(b, kc, h, w)
        return self.f_up(context)


class SpatialOCR(nn.Module):
    """cat(object context, feats) -> 1x1 conv -> BN -> ReLU -> Dropout(0.05)."""

    def __init__(self, in_ch, key_channels, out_ch, dropout=0.05, generator=None):
        super().__init__()
        g = generator
        self.object_context_block = ObjectAttention(in_ch, key_channels, generator=g)
        self.conv_bn_dropout = nn.Sequential(
            conv2d(2 * in_ch, out_ch, 1, generator=g),
            nn.Sequential(BatchNorm2d(out_ch), nn.ReLU()), Dropout(dropout))

    def forward(self, feats, proxy, generator=None):
        context = self.object_context_block(feats, proxy)
        conv, bn_relu, drop = self.conv_bn_dropout
        return drop(bn_relu(conv(torch.cat([context, feats], dim=1))), generator)


class HRNetW48OCR(nn.Module):
    """forward(x, generator=None) -> (main_sigmoid, aux_sigmoid) at the input size."""

    def __init__(self, num_classes=1, width=48, generator=None):
        super().__init__()
        g = generator
        in_ch = 15 * width
        self.backbone = HRNetW48Backbone(width, generator=g)
        self.aux_head = nn.Sequential(
            conv2d(in_ch, in_ch, 3, padding=1, generator=g),
            nn.Sequential(BatchNorm2d(in_ch), nn.ReLU()),
            conv2d(in_ch, num_classes, 1, generator=g))
        self.conv3x3 = nn.Sequential(conv2d(in_ch, 512, 3, padding=1, generator=g),
                                     nn.Sequential(BatchNorm2d(512), nn.ReLU()))
        self.ocr_distri_head = SpatialOCR(512, 256, 512, generator=g)
        self.cls_head = conv2d(512, num_classes, 1, generator=g)

    def forward(self, x, generator=None):
        hw_in = x.shape[2:]
        xs = self.backbone(x)
        hw = xs[0].shape[2:]
        feats = torch.cat([xs[0]] + [_up(t, hw) for t in xs[1:]], dim=1)
        aux = self.aux_head(feats)
        f = self.conv3x3(feats)
        f = self.ocr_distri_head(f, spatial_gather(f, aux), generator)
        out = self.cls_head(f)
        return torch.sigmoid(_up(out, hw_in)), torch.sigmoid(_up(aux, hw_in))
