"""PSPNet with the dilated ResNet-34 extractor (`csbsr_tpu/models/pspnet.py`).

ResNet-34 with layers 3/4 dilated (stride 1, dilation 2/4; the first block
of each layer undilated), /8 in all; pyramid pooling (1, 2, 3, 6); three 2x
bilinear-upsample conv stages; sigmoid main head plus an aux head on the
layer-3 features. Only the resnet34 backend is ported. BatchNorm (eps 1e-5)
uses its running statistics in eval; dropout is the identity in eval.
Tensors are NCHW; attribute names are the reference's.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm2d, PReLU, conv2d
from ..ops.resize import adaptive_avg_pool, resize


class BasicBlock(nn.Module):
    def __init__(self, in_ch, planes, stride=1, dilation=1, generator=None):
        super().__init__()
        d, g = dilation, generator
        self.conv1 = conv2d(in_ch, planes, 3, stride, d, d, bias=False, generator=g)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, d, d, bias=False, generator=g)
        self.bn2 = BatchNorm2d(planes)
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                conv2d(in_ch, planes, 1, stride, bias=False, generator=g), BatchNorm2d(planes))
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNet34Dilated(nn.Module):
    """Returns (layer4, layer3) features at /8."""

    def __init__(self, layers=(3, 4, 6, 3), generator=None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(3, 64, 7, 2, 3, bias=False, generator=g)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for i, (planes, blocks, stride, dil) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 1, 1), (1, 1, 2, 4)), start=1):
            mods = [BasicBlock(in_ch, planes, stride, 1, generator=g)]
            mods += [BasicBlock(planes, planes, 1, dil, generator=g) for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*mods))
            in_ch = planes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer2(self.layer1(x))
        x3 = self.layer3(x)
        return self.layer4(x3), x3


class PSPModule(nn.Module):
    """Pyramid pooling (1, 2, 3, 6) + 1x1 bottleneck + ReLU."""

    def __init__(self, features, out_features=1024, sizes=(1, 2, 3, 6), generator=None):
        super().__init__()
        self.sizes = sizes
        # (AdaptiveAvgPool2d, Conv2d) pairs in the reference; pooling is
        # stateless, so index 0 is an identity placeholder with no params
        self.stages = nn.ModuleList([
            nn.Sequential(nn.Identity(), conv2d(features, features, 1, bias=False,
                                                generator=generator))
            for _ in sizes
        ])
        self.bottleneck = conv2d(features * (len(sizes) + 1), out_features, 1,
                                 generator=generator)

    def forward(self, feats):
        h, w = feats.shape[2:]
        priors = [
            resize(stage[1](adaptive_avg_pool(feats, (size, size))), (h, w), method="bilinear")
            for size, stage in zip(self.sizes, self.stages)
        ]
        return F.relu(self.bottleneck(torch.cat(priors + [feats], dim=1)))


class PSPUpsample(nn.Module):
    """2x bilinear -> conv3x3 -> BN -> PReLU (`conv` = Sequential(Conv, BN, PReLU))."""

    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        self.conv = nn.Sequential(conv2d(in_ch, out_ch, 3, padding=1, generator=generator),
                                  BatchNorm2d(out_ch), PReLU(init=0.25))

    def forward(self, x):
        h, w = 2 * x.shape[2], 2 * x.shape[3]
        return self.conv(resize(x, (h, w), method="bilinear"))


class PSPNet(nn.Module):
    """forward(x) -> (main_sigmoid, aux_sigmoid), both at the input size."""

    def __init__(self, n_classes=1, backend="resnet34", generator=None):
        super().__init__()
        if backend != "resnet34":
            raise NotImplementedError(
                f"PSPNet backend {backend!r} is not ported yet (resnet34 only); "
                "see ROADMAP.md, queue 1"
            )
        g = generator
        self.feats = ResNet34Dilated(generator=g)
        self.psp = PSPModule(512, 1024, generator=g)
        self.up_1 = PSPUpsample(1024, 256, generator=g)
        self.up_2 = PSPUpsample(256, 64, generator=g)
        self.up_3 = PSPUpsample(64, 64, generator=g)
        self.final = nn.Sequential(conv2d(64, n_classes, 1, generator=g), nn.Sigmoid())
        self.aux = nn.Sequential(
            conv2d(256, 256, 3, padding=1, bias=False, generator=g), BatchNorm2d(256),
            nn.ReLU(), nn.Dropout(0.1), conv2d(256, n_classes, 1, generator=g), nn.Sigmoid(),
        )

    def forward(self, x):
        h, w = x.shape[2:]
        f, aux_f = self.feats(x)
        p = self.psp(f)
        p = self.up_3(self.up_2(self.up_1(p)))
        main = self.final(p)
        aux = resize(self.aux(aux_f), (h, w), method="bilinear", align_corners=True)
        return main, aux
