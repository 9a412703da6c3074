"""SrcNetSR (RCAN-like SR) and SegNet (`csbsr_tpu/models/srcnet.py`).

SrcNetSR: conv -> residual in residual (`rir`: 10 groups of 20
channel-attention residual blocks, each group closed by a conv and a skip,
then a conv and the long skip) -> deconv upscale (per-scale (k, s, p) of
`_DECONV_SETTING`, 256 channels) -> conv to RGB. Its block returns s * m
with no skip, as the reference does (and the JAX package mirrors). The
attention's two 1x1 convs are plain convs in the JAX package, so they stay
in the compute dtype in int8 serving (`keep_float`). SrcNetSR predicts no
kernel.

SegNet: a VGG-shaped encoder (conv, BatchNorm, ReLU; 2x2 max pool with
window-local indices) and a decoder that unpools with those indices; sigmoid
output, no aux map. The reference names its decoder convs in descending
order (ConvDe53 runs first), and its final conv is ConvDe11; its
declared BNDe11 is unused (`utils/convert.drop_unused_reference_keys`
drops it from a released checkpoint). Five pools need H and W divisible
by 32. Tensors are NCHW; attribute names are the reference's.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm2d, conv2d, deconv2d, keep_float, max_pool_with_indices, max_unpool

_DECONV_SETTING = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


class CAResBlock(nn.Module):
    """fe1 = (conv, ReLU, conv); attention = (pool, conv C/2, sigmoid, conv C,
    ReLU) over the channel means; returns attention * features."""

    def __init__(self, ch, generator=None):
        super().__init__()
        g = generator
        self.fe1 = nn.Sequential(conv2d(ch, ch, 3, padding=1, generator=g), nn.ReLU(),
                                 conv2d(ch, ch, 3, padding=1, generator=g))
        self.attention = keep_float(nn.Sequential(
            nn.Identity(), conv2d(ch, ch // 2, 1, generator=g), nn.Sigmoid(),
            conv2d(ch // 2, ch, 1, generator=g), nn.ReLU()))

    def forward(self, x):
        m = self.fe1(x)
        s = m.mean(dim=(2, 3), keepdim=True)
        return self.attention[1:](s) * m


class ResidualGroup(nn.Module):
    def __init__(self, ch, n_blocks, generator=None):
        super().__init__()
        self.res_blocks = nn.ModuleList([CAResBlock(ch, generator) for _ in range(n_blocks)])
        self.conv = conv2d(ch, ch, 3, padding=1, generator=generator)

    def forward(self, x):
        f = x
        for block in self.res_blocks:
            f = block(f)
        return x + self.conv(f)


class RIR(nn.Module):
    def __init__(self, ch, n_groups, n_blocks, generator=None):
        super().__init__()
        self.res_groups = nn.ModuleList([ResidualGroup(ch, n_blocks, generator)
                                         for _ in range(n_groups)])
        self.conv = conv2d(ch, ch, 3, padding=1, generator=generator)

    def forward(self, x):
        f = x
        for group in self.res_groups:
            f = group(f)
        return x + self.conv(f)


class SrcNetSR(nn.Module):
    """forward(x, compute_dtype) -> sr (B, 3, sH, sW) in the compute dtype."""

    def __init__(self, scale_factor=4, base_ch=64, n_groups=10, n_blocks=20, generator=None):
        super().__init__()
        g = generator
        k, s, p = _DECONV_SETTING[scale_factor]
        self.sconv1 = conv2d(3, base_ch, 3, padding=1, generator=g)
        self.rir = RIR(base_ch, n_groups, n_blocks, g)
        self.upscaling = deconv2d(base_ch, 256, k, s, p, generator=g)
        self.sconv2 = conv2d(256, 3, 3, padding=1, generator=g)

    def forward(self, x, compute_dtype: torch.dtype = torch.float32):
        f = self.rir(self.sconv1(x.to(compute_dtype)))
        return self.sconv2(self.upscaling(f))


# (stage, channels in application order); a decoder stage's torch indices
# run from n down to 1 (De1: its one 3x3 conv is ConvDe12, ConvDe11 the final conv)
_ENCODER = (("En1", (64, 64)), ("En2", (128, 128)), ("En3", (256, 256, 256)),
            ("En4", (512, 512, 512)), ("En5", (512, 512, 512)))
_DECODER = (("De5", (512, 512, 512)), ("De4", (512, 512, 256)), ("De3", (256, 256, 128)),
            ("De2", (128, 64)), ("De1", (64,)))


def _decoder_names(tag, n):
    return [f"{tag}{2 if tag == 'De1' else n - j}" for j in range(n)]


class SegNet(nn.Module):
    """forward(x, generator=None) -> (sigmoid map (B, out_ch, H, W), None)."""

    def __init__(self, in_ch=3, out_ch=1, generator=None):
        super().__init__()
        g = generator
        # conv / BN name suffixes per stage, in application order
        self.encoder = [[f"{tag}{j + 1}" for j in range(len(c))] for tag, c in _ENCODER]
        self.decoder = [_decoder_names(tag, len(c)) for tag, c in _DECODER]
        for names, (_, chans) in zip(self.encoder + self.decoder, _ENCODER + _DECODER):
            for name, ch in zip(names, chans):
                setattr(self, f"Conv{name}", conv2d(in_ch, ch, 3, padding=1, generator=g))
                setattr(self, f"BN{name}", BatchNorm2d(ch))
                in_ch = ch
        self.ConvDe11 = conv2d(in_ch, out_ch, 3, padding=1, generator=g)

    def _cbr(self, x, name):
        return F.relu(getattr(self, f"BN{name}")(getattr(self, f"Conv{name}")(x)))

    def forward(self, x, generator=None):
        indices = []
        for names in self.encoder:
            for name in names:
                x = self._cbr(x, name)
            x, idx = max_pool_with_indices(x, 2)
            indices.append(idx)
        for names, idx in zip(self.decoder, reversed(indices)):
            x = max_unpool(x, idx, 2)
            for name in names:
                x = self._cbr(x, name)
        return torch.sigmoid(self.ConvDe11(x)), None
