"""DSRL, the parallel SR + segmentation baseline (DeepLabV3+)
(`csbsr_tpu/models/dsrl.py`).

backbone -> ASPP -> seg decoder (sigmoid) and SR decoder (64 channels) ->
EDSR-style deconv chain (x2 deconvs from the decoders' /4 to x2 or x4 of
the input). forward returns (seg, sr, fea_seg, fea_sr), the feature pair of
the FA loss: fea_seg is a 1x1 conv + BatchNorm + ReLU of the upsampled seg
map, fea_sr the SR image itself.

Backbones (`TPU.DSRL_BACKBONE`):
  - "resnet": ResNet-101, output stride 16: strides (1, 2, 2, 1), dilations
    (1, 1, 1, 2), layer 4 multi-grid (1, 2, 4); low-level feature layer 1
    (256 channels at /4);
  - "drn": DRN-D-54, output stride 8 (ASPP rates 12, 24, 36): conv stacks
    layer0-2 and layer7-8, bottleneck layers 3-6 (5 and 6 dilated 2 and 4);
    low-level feature layer 3;
  - "mobilenet": MobileNetV2 at output stride 16, the fixed-padding
    depthwise convs; low-level feature after features[0:4] (24 channels);
  - "xception": Aligned Xception at output stride 16 (16 middle blocks, exit
    separable convs dilated 2); low-level feature ReLU(block1) (128 channels).

Names are the reference's (pytorch-deeplab-xception's backbones, DSRL's
deeplab.py): the DeepLab x2 chain is up_sr_1..3 / up_edsr_1..3, the x4
chain (DeepLabx4) up_sr_0..3. MobileNetV2's blocks live in `features` only
(the reference also registers them as `low_level_features` /
`high_level_features`, which hold the same tensors).

The JAX package's plain convs (not qconv) stay in the compute dtype in int8
serving (`keep_float`): the depthwise convs of MobileNetV2 and Xception and
ASPP's image-pooling conv. BatchNorm (eps 1e-5, momentum 0.1 = flax 0.9)
uses its running statistics in eval and the batch's in train. Dropout 0.5
after ASPP and after each decoder's first conv, 0.1 after its second, in
train mode with the step's generator. Tensors are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm2d, Dropout, conv2d, deconv2d, keep_float
from ..ops.resize import adaptive_avg_pool, resize

BACKBONES = ("resnet", "drn", "mobilenet", "xception")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4), BatchNorm after each, a
    1x1 conv + BatchNorm downsample where the shape changes."""

    def __init__(self, in_ch, planes, stride=1, dilation=1, generator=None):
        super().__init__()
        g, d = generator, dilation
        self.conv1 = conv2d(in_ch, planes, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, d, d, bias=False, generator=g)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv2d(planes, planes * 4, 1, bias=False, generator=g)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or in_ch != planes * 4:
            self.downsample = nn.Sequential(
                conv2d(in_ch, planes * 4, 1, stride, bias=False, generator=g),
                BatchNorm2d(planes * 4))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


def _bottleneck_layer(in_ch, planes, dilations, stride, generator):
    """Bottlenecks, the first with `stride`, block b dilated dilations[b]."""
    blocks = []
    for b, d in enumerate(dilations):
        blocks.append(Bottleneck(in_ch, planes, stride if b == 0 else 1, d, generator))
        in_ch = planes * 4
    return nn.Sequential(*blocks)


class ResNet101OS16(nn.Module):
    """forward(x) -> (features /16, 2048 ch; low-level /4, 256 ch)."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(3, 64, 7, 2, 3, bias=False, generator=g)
        self.bn1 = BatchNorm2d(64)
        self.layer1 = _bottleneck_layer(64, 64, (1,) * 3, 1, g)
        self.layer2 = _bottleneck_layer(256, 128, (1,) * 4, 2, g)
        self.layer3 = _bottleneck_layer(512, 256, (1,) * 23, 2, g)
        self.layer4 = _bottleneck_layer(1024, 512, (2, 4, 8), 1, g)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        low = self.layer1(x)
        return self.layer4(self.layer3(self.layer2(low))), low


def _conv_layer(in_ch, ch, convs, stride, dilation, generator):
    """drn.py _make_conv_layers: (3x3 conv, BatchNorm, ReLU) x convs."""
    mods = []
    for i in range(convs):
        mods += [conv2d(in_ch if i == 0 else ch, ch, 3, stride if i == 0 else 1, dilation,
                        dilation, bias=False, generator=generator), BatchNorm2d(ch), nn.ReLU()]
    return nn.Sequential(*mods)


class DRND54(nn.Module):
    """forward(x) -> (features /8, 512 ch; low-level /4, 256 ch)."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.layer0 = nn.Sequential(conv2d(3, 16, 7, 1, 3, bias=False, generator=g),
                                    BatchNorm2d(16), nn.ReLU())
        self.layer1 = _conv_layer(16, 16, 1, 1, 1, g)
        self.layer2 = _conv_layer(16, 32, 1, 2, 1, g)
        self.layer3 = _bottleneck_layer(32, 64, (1,) * 3, 2, g)
        self.layer4 = _bottleneck_layer(256, 128, (1,) * 4, 2, g)
        self.layer5 = _bottleneck_layer(512, 256, (2,) * 6, 1, g)
        self.layer6 = _bottleneck_layer(1024, 512, (4,) * 3, 1, g)
        self.layer7 = _conv_layer(2048, 512, 1, 1, 2, g)
        self.layer8 = _conv_layer(512, 512, 1, 1, 1, g)

    def forward(self, x):
        low = self.layer3(self.layer2(self.layer1(self.layer0(x))))
        x = self.layer6(self.layer5(self.layer4(low)))
        return self.layer8(self.layer7(x)), low


class InvertedResidual(nn.Module):
    """MobileNetV2 block: (1x1 expand, BN, ReLU6), depthwise 3x3 (padding =
    dilation each side), BN, ReLU6, 1x1 project, BN; + x where shapes allow.
    `conv` holds them as the reference's Sequential (no expand conv at
    expand ratio 1)."""

    def __init__(self, in_ch, out_ch, stride, dilation, expand_ratio, generator=None):
        super().__init__()
        g, d = generator, dilation
        hidden = round(in_ch * expand_ratio)
        mods = []
        if expand_ratio != 1:
            mods += [conv2d(in_ch, hidden, 1, bias=False, generator=g), BatchNorm2d(hidden),
                     nn.ReLU6()]
        mods += [keep_float(conv2d(hidden, hidden, 3, stride, d, d, bias=False, generator=g,
                                   groups=hidden)),
                 BatchNorm2d(hidden), nn.ReLU6(),
                 conv2d(hidden, out_ch, 1, bias=False, generator=g), BatchNorm2d(out_ch)]
        self.conv = nn.Sequential(*mods)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self.conv(x)
        return x + h if self.use_res else h


# (expand ratio, channels, blocks, stride, dilation) at output stride 16
_MOBILENET_SETTINGS = ((1, 16, 1, 1, 1), (6, 24, 2, 2, 1), (6, 32, 3, 2, 1), (6, 64, 4, 2, 1),
                       (6, 96, 3, 1, 1), (6, 160, 3, 1, 1), (6, 320, 1, 1, 2))
_MOBILENET_LOW = 4  # features[0:4]: the stem and three blocks


class MobileNetV2OS16(nn.Module):
    """forward(x) -> (features /16, 320 ch; low-level /4, 24 ch)."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        feats = [nn.Sequential(conv2d(3, 32, 3, 2, 1, bias=False, generator=g),
                               BatchNorm2d(32), nn.ReLU6())]
        in_ch = 32
        for t, c, n, s, d in _MOBILENET_SETTINGS:
            for i in range(n):
                feats.append(InvertedResidual(in_ch, c, s if i == 0 else 1, d, t, g))
                in_ch = c
        self.features = nn.Sequential(*feats)

    def forward(self, x):
        low = self.features[:_MOBILENET_LOW](x)
        return self.features[_MOBILENET_LOW:](low), low


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (`conv1`, padding = dilation each side), BatchNorm
    (`bn`), pointwise 1x1."""

    def __init__(self, in_ch, out_ch, stride=1, dilation=1, generator=None):
        super().__init__()
        g, d = generator, dilation
        self.conv1 = keep_float(conv2d(in_ch, in_ch, 3, stride, d, d, bias=False, generator=g,
                                       groups=in_ch))
        self.bn = BatchNorm2d(in_ch)
        self.pointwise = conv2d(in_ch, out_ch, 1, bias=False, generator=g)

    def forward(self, x):
        return self.pointwise(self.bn(self.conv1(x)))


class XceptionBlock(nn.Module):
    """`rep`: (ReLU, SeparableConv2d, BatchNorm) per separable conv, the first
    ReLU dropped unless start_with_relu; `skip` / `skipbn` a 1x1 conv +
    BatchNorm where the shape changes, else the identity."""

    def __init__(self, in_ch, planes, reps, stride=1, dilation=1, start_with_relu=True,
                 grow_first=True, is_last=False, generator=None):
        super().__init__()
        g = generator
        ops = []  # (in, out, stride, dilation) of each separable conv
        filters = in_ch
        if grow_first:
            ops.append((in_ch, planes, 1, dilation))
            filters = planes
        ops += [(filters, filters, 1, dilation)] * (reps - 1)
        if not grow_first:
            ops.append((in_ch, planes, 1, dilation))
        if stride != 1:
            ops.append((planes, planes, 2, 1))
        if stride == 1 and is_last:
            ops.append((planes, planes, 1, 1))
        rep = []
        for cin, cout, s, d in ops:
            rep += [nn.ReLU(), SeparableConv2d(cin, cout, s, d, g), BatchNorm2d(cout)]
        self.rep = nn.Sequential(*(rep if start_with_relu else rep[1:]))
        self.skip = None
        if planes != in_ch or stride != 1:
            self.skip = conv2d(in_ch, planes, 1, stride, bias=False, generator=g)
            self.skipbn = BatchNorm2d(planes)

    def forward(self, x):
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class AlignedXceptionOS16(nn.Module):
    """forward(x) -> (features /16, 2048 ch; low-level /4, 128 ch)."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(3, 32, 3, 2, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(32)
        self.conv2 = conv2d(32, 64, 3, 1, 1, bias=False, generator=g)
        self.bn2 = BatchNorm2d(64)
        self.block1 = XceptionBlock(64, 128, 2, 2, start_with_relu=False, generator=g)
        self.block2 = XceptionBlock(128, 256, 2, 2, start_with_relu=False, generator=g)
        self.block3 = XceptionBlock(256, 728, 2, 2, is_last=True, generator=g)
        for i in range(4, 20):
            setattr(self, f"block{i}", XceptionBlock(728, 728, 3, generator=g))
        self.block20 = XceptionBlock(728, 1024, 2, 1, 1, grow_first=False, is_last=True,
                                     generator=g)
        for i, (cin, cout) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
            setattr(self, f"conv{i}", SeparableConv2d(cin, cout, 1, 2, g))
            setattr(self, f"bn{i}", BatchNorm2d(cout))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        low = F.relu(self.block1(x))
        x = self.block3(self.block2(low))
        for i in range(4, 21):
            x = getattr(self, f"block{i}")(x)
        for i in (3, 4, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x, low


class ASPPModule(nn.Module):
    def __init__(self, in_ch, kernel_size, dilation, generator=None):
        super().__init__()
        p = (kernel_size // 2) * dilation
        self.atrous_conv = conv2d(in_ch, 256, kernel_size, 1, p, dilation, bias=False,
                                  generator=generator)
        self.bn = BatchNorm2d(256)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Four atrous branches (1x1; 3x3 at rates 6, 12, 18, or 12, 24, 36 at
    output stride 8) and image pooling (`global_avg_pool`: pool, 1x1 conv,
    BN, ReLU, broadcast back), concatenated, 1x1 conv, BN, ReLU, dropout 0.5."""

    def __init__(self, in_ch, output_stride=16, generator=None):
        super().__init__()
        g = generator
        rates = (6, 12, 18) if output_stride == 16 else (12, 24, 36)
        for i, (k, d) in enumerate(((1, 1),) + tuple((3, r) for r in rates), start=1):
            setattr(self, f"aspp{i}", ASPPModule(in_ch, k, d, g))
        self.global_avg_pool = nn.Sequential(
            nn.Identity(), keep_float(conv2d(in_ch, 256, 1, bias=False, generator=g)),
            BatchNorm2d(256), nn.ReLU())
        self.conv1 = conv2d(1280, 256, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(256)
        self.dropout = Dropout(0.5)

    def forward(self, x, generator=None):
        outs = [getattr(self, f"aspp{i}")(x) for i in range(1, 5)]
        pooled = self.global_avg_pool[1:](adaptive_avg_pool(x, (1, 1)))
        outs.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        out = F.relu(self.bn1(self.conv1(torch.cat(outs, dim=1))))
        return self.dropout(out, generator)


class Decoder(nn.Module):
    """decoder.py / sr_decoder.py: low-level 1x1 conv (48) + BN + ReLU; the
    ASPP output resized to it (bilinear, align_corners) and concatenated;
    `last_conv` = 3x3 (256) BN ReLU dropout 0.5, 3x3 (mid) BN ReLU dropout
    0.1, 1x1 (out, with bias); sigmoid for the seg decoder."""

    def __init__(self, low_ch, out_ch, mid, sigmoid_out, generator=None):
        super().__init__()
        g = generator
        self.sigmoid_out = sigmoid_out
        self.conv1 = conv2d(low_ch, 48, 1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(48)
        self.last_conv = nn.Sequential(
            conv2d(304, 256, 3, padding=1, bias=False, generator=g), BatchNorm2d(256), nn.ReLU(),
            Dropout(0.5), conv2d(256, mid, 3, padding=1, bias=False, generator=g),
            BatchNorm2d(mid), nn.ReLU(), Dropout(0.1), conv2d(mid, out_ch, 1, generator=g))

    def forward(self, x, low, generator=None):
        low = F.relu(self.bn1(self.conv1(low)))
        x = torch.cat([resize(x, low.shape[2:], method="bilinear", align_corners=True), low],
                      dim=1)
        for layer in self.last_conv:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return torch.sigmoid(x) if self.sigmoid_out else x


class EDSRConv(nn.Module):
    """deeplab.py EDSRConv: conv = (3x3, ReLU, 3x3), plus a 1x1 residual."""

    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        g = generator
        self.conv = nn.Sequential(conv2d(in_ch, out_ch, 3, padding=1, generator=g), nn.ReLU(),
                                  conv2d(out_ch, out_ch, 3, padding=1, generator=g))
        self.residual_upsampler = nn.Sequential(conv2d(in_ch, out_ch, 1, bias=False, generator=g))

    def forward(self, x):
        return self.conv(x) + self.residual_upsampler(x)


class DSRL(nn.Module):
    """forward(x, generator=None) -> (seg, sr, fea_seg, fea_sr) at
    scale_factor (2 or 4) x the input size, in x's dtype."""

    def __init__(self, num_classes=1, scale_factor=4, backbone="resnet", generator=None):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"DSRL backbone {backbone!r}: one of {BACKBONES}")
        g = generator
        cls = {"resnet": ResNet101OS16, "drn": DRND54, "mobilenet": MobileNetV2OS16,
               "xception": AlignedXceptionOS16}[backbone]
        self.backbone = cls(g)
        high_ch, low_ch = {"resnet": (2048, 256), "drn": (512, 256), "mobilenet": (320, 24),
                           "xception": (2048, 128)}[backbone]
        self.aspp = ASPP(high_ch, 8 if backbone == "drn" else 16, g)
        self.decoder = Decoder(low_ch, num_classes, 256, True, g)
        self.sr_decoder = Decoder(low_ch, 64, 128, False, g)
        chans = (64, 64, 32, 16) if scale_factor == 4 else (64, 32, 16)
        self.chain = [f"{i + 4 - len(chans)}" for i in range(len(chans))]  # torch indices
        in_ch = 64
        for i, ch in zip(self.chain, chans):
            setattr(self, f"up_sr_{i}", deconv2d(in_ch, ch, 2, 2, 0, generator=g))
            setattr(self, f"up_edsr_{i}", EDSRConv(ch, ch, g))
            in_ch = ch
        self.up_conv_last = conv2d(16, 3, 1, generator=g)
        self.pointwise = nn.Sequential(conv2d(num_classes, 3, 1, generator=g),
                                       BatchNorm2d(3), nn.ReLU())

    def forward(self, x, generator=None):
        feats, low = self.backbone(x)
        a = self.aspp(feats, generator)
        seg = self.decoder(a, low, generator)
        sr = self.sr_decoder(a, low, generator)
        scale = 2 ** len(self.chain) // 4
        out_hw = (x.shape[2] * scale, x.shape[3] * scale)
        seg = resize(resize(seg, x.shape[2:], method="bilinear", align_corners=True), out_hw,
                     method="bilinear", align_corners=True)
        for i in self.chain:
            sr = getattr(self, f"up_edsr_{i}")(getattr(self, f"up_sr_{i}")(sr))
        sr = self.up_conv_last(sr)
        return seg, sr, self.pointwise(seg), sr
