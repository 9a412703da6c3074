"""DBPN, dense deep back-projection (`csbsr_tpu/models/dbpn.py`), Net_T wiring.

feat0 3x3 conv (256) -> feat1 1x1 conv (64) -> up1, down1, up2, then
D_Down(t-1) / D_Up(t) pairs over growing dense concats (newest first) for
t = 3..T -> output conv over the concat of every up-projection. Every block
is of the base_networks family (bias, PReLU 0.25); per-scale (kernel,
stride, padding) x2 (6, 2, 2), x4 (8, 4, 2), x8 (12, 8, 2). DBPN predicts no
kernel. Tensors are NCHW; the model runs in the compute dtype it is given.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import DBPNConvBlock, DownBlock, UpBlock

_CONV_SETTING = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}
FEAT_CH, BASE_CH = 256, 64  # every Net_T of the reference


class DBPN(nn.Module):
    """forward(x, compute_dtype) -> sr (B, 3, sH, sW) in the compute dtype."""

    def __init__(self, scale_factor=4, num_channels=3, num_stages=4, generator=None):
        super().__init__()
        g = generator
        k, s, p = _CONV_SETTING[scale_factor]
        self.num_stages = num_stages
        self.feat0 = DBPNConvBlock(num_channels, FEAT_CH, 3, 1, 1, generator=g)
        self.feat1 = DBPNConvBlock(FEAT_CH, BASE_CH, 1, 1, 0, generator=g)
        self.up1 = UpBlock(BASE_CH, k, s, p, generator=g)
        if num_stages > 1:
            self.down1 = DownBlock(BASE_CH, k, s, p, generator=g)
            self.up2 = UpBlock(BASE_CH, k, s, p, generator=g)
        for t in range(3, num_stages + 1):
            cat = (t - 1) * BASE_CH
            setattr(self, f"down{t - 1}", DownBlock(BASE_CH, k, s, p, in_ch=cat, generator=g))
            setattr(self, f"up{t}", UpBlock(BASE_CH, k, s, p, in_ch=cat, generator=g))
        self.output_conv = DBPNConvBlock(num_stages * BASE_CH, num_channels, 3, 1, 1,
                                         activation=None, generator=g)

    def forward(self, x, compute_dtype: torch.dtype = torch.float32):
        x = self.feat1(self.feat0(x.to(compute_dtype)))
        h1 = self.up1(x)
        if self.num_stages == 1:
            return self.output_conv(h1)
        l1 = self.down1(h1)
        concat_h = torch.cat([self.up2(l1), h1], dim=1)
        concat_l = l1
        for t in range(3, self.num_stages + 1):
            concat_l = torch.cat([getattr(self, f"down{t - 1}")(concat_h), concat_l], dim=1)
            concat_h = torch.cat([getattr(self, f"up{t}")(concat_l), concat_h], dim=1)
        return self.output_conv(concat_h)
