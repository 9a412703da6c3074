"""UNet16, the VGG16-encoder U-Net segmentation head (`csbsr_tpu/models/unet.py`).

Encoder: the VGG16 conv blocks conv1..conv5 (2, 2, 3, 3, 3 convs with ReLU,
2x2 max pools between; `center` takes conv5 unpooled). Decoder:
DecoderBlockV2 (`MODEL.UP_SAMPLE_METHOD`: deconv, pixel_shuffle or
interpolate) with skip concats, then a 3x3 conv (dec1) and a 1x1 conv to a
sigmoid map. Torch names: conv<i>.<seq index>, <dec>.block.<i>, dec1.conv,
final. The pixel shuffle is `F.pixel_shuffle` on NCHW: channel c*r*r + i*r + j
goes to output channel c at offset (i, j), which is what the JAX package's
NHWC pixel_shuffle computes (`tests/test_torch_port_zoo.py` holds the two
together). Tensors are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import conv2d, deconv2d
from ..ops.resize import resize


class ConvRelu(nn.Module):
    """3x3 conv (bias) -> ReLU; the conv at `.conv`."""

    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        self.conv = conv2d(in_ch, out_ch, 3, padding=1, generator=generator)

    def forward(self, x):
        return F.relu(self.conv(x))


class _Upsample2x(nn.Module):
    def forward(self, x):
        return resize(x, (2 * x.shape[2], 2 * x.shape[3]), method="bilinear")


class DecoderBlockV2(nn.Module):
    """deconv: ConvRelu -> ConvTranspose(4, 2, 1) -> ReLU;
    pixel_shuffle: ConvRelu -> PixelShuffle(2) -> ReLU (out = middle / 4);
    interpolate: 2x bilinear -> ConvRelu -> ConvRelu."""

    def __init__(self, in_ch, middle_ch, out_ch, method="deconv", generator=None):
        super().__init__()
        g = generator
        if method == "deconv":
            deconv = deconv2d(middle_ch, out_ch, 4, 2, 1, generator=g)
            self.block = nn.Sequential(ConvRelu(in_ch, middle_ch, g), deconv, nn.ReLU())
        elif method == "pixel_shuffle":
            self.block = nn.Sequential(ConvRelu(in_ch, middle_ch, g), nn.PixelShuffle(2),
                                       nn.ReLU())
        elif method == "interpolate":
            self.block = nn.Sequential(_Upsample2x(), ConvRelu(in_ch, middle_ch, g),
                                       ConvRelu(middle_ch, out_ch, g))
        else:
            raise NotImplementedError(method)

    def forward(self, x):
        return self.block(x)


class UNet16(nn.Module):
    """forward(x) -> sigmoid map (num_classes 1) or log-softmax."""

    def __init__(self, num_classes=1, num_filters=32, up_sampling_method="deconv",
                 generator=None):
        super().__init__()
        g, nf = generator, num_filters
        self.num_classes = num_classes

        def vgg(in_ch, chans):
            mods = []
            for ch in chans:
                mods += [conv2d(in_ch, ch, 3, padding=1, generator=g), nn.ReLU()]
                in_ch = ch
            return nn.Sequential(*mods)

        self.conv1 = vgg(3, [64, 64])
        self.conv2 = vgg(64, [128, 128])
        self.conv3 = vgg(128, [256] * 3)
        self.conv4 = vgg(256, [512] * 3)
        self.conv5 = vgg(512, [512] * 3)
        dec = lambda i, mid, out: DecoderBlockV2(i, mid, out, up_sampling_method, generator=g)
        self.center = dec(512, nf * 8 * 4, nf * 8)
        self.dec4 = dec(nf * 8 + 512, nf * 8 * 4, nf * 8)
        self.dec3 = dec(nf * 8 + 256, nf * 4 * 4, nf * 4)
        self.dec2 = dec(nf * 4 + 128, nf * 4 * 2, nf * 2)
        self.dec1 = ConvRelu(nf * 2 + 64, nf, g)
        self.final = conv2d(nf, num_classes, 1, generator=g)

    def forward(self, x):
        pool = lambda v: F.max_pool2d(v, 2, 2)
        conv1 = self.conv1(x)
        conv2 = self.conv2(pool(conv1))
        conv3 = self.conv3(pool(conv2))
        conv4 = self.conv4(pool(conv3))
        conv5 = self.conv5(pool(conv4))
        center = self.center(conv5)
        dec4 = self.dec4(torch.cat([center, conv4], dim=1))
        dec3 = self.dec3(torch.cat([dec4, conv3], dim=1))
        dec2 = self.dec2(torch.cat([dec3, conv2], dim=1))
        out = self.final(self.dec1(torch.cat([dec2, conv1], dim=1)))
        if self.num_classes > 1:
            return F.log_softmax(out, dim=1)
        return torch.sigmoid(out)
