"""Shared blocks (`csbsr_tpu/models/blocks.py`), in NCHW PyTorch.

Module and attribute names are the original CSBSR torch names, so the
state-dict keys are the ones the JAX package's translators emit and a
released reference `.pth` loads as is. Two block families:

  - BlockBase (ConvBlock/DeconvBlock; KBPN, the SFT blocks, the BlurSkip
    ladder): conv in `.layer`, BatchNorm in `.norm`, activation in `.act`;
    ReLU / PReLU(0.01) / LeakyReLU(0.01) / sigmoid or none, no bias unless
    asked for.
  - base_networks (DBPNConvBlock/DBPNDeconvBlock; DBPN's Up/Down blocks,
    the D_ variants being UpBlock/DownBlock with a merge conv):
    conv in `.conv` or `.deconv`, PReLU(0.25) in `.act`, with bias.

`max_pool_with_indices` / `max_unpool` are the JAX package's window-local
argmax pair (CrackFormer), not `F.max_pool2d(return_indices=True)`.

Params are float32. Every layer computes in the dtype of its input (the
model's compute dtype) and casts its weights to it, as the flax modules do
with `dtype=`. BatchNorm and Dropout follow flax's train-mode semantics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import upcast

# -------------------------------------------------------------------- init


def kaiming_normal_leaky_(w: torch.Tensor, a: float, generator: torch.Generator) -> torch.Tensor:
    """torch kaiming_normal_(mode='fan_in', nonlinearity='leaky_relu', a=a),
    fan_in = I*kh*kw (the weight's (O, I, kh, kw) layout; for a transposed
    conv (I, O, kh, kw) it is O*kh*kw, as flax's (kh, kw, O, I) kernel
    gives)."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    fan_in = w[0].numel()
    with torch.no_grad():
        return w.normal_(0.0, gain / math.sqrt(fan_in), generator=generator)


def xavier_normal_(w: torch.Tensor, gain: float, generator: torch.Generator) -> torch.Tensor:
    """Glorot normal with the JAX package's fan convention."""
    receptive = w[0, 0].numel()
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    with torch.no_grad():
        return w.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: variance 1/fan_in, truncated normal in
    flax; a plain normal here (random weights only need the scale)."""
    with torch.no_grad():
        return w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=generator)


def init_for_activation_(w: torch.Tensor, activation: Optional[str], generator) -> None:
    """Weight init convention of BlockBase.create_block, keyed on the
    block's activation."""
    if activation == "relu":
        kaiming_normal_leaky_(w, 0.0, generator)
    elif activation in ("prelu", "lrelu"):
        kaiming_normal_leaky_(w, 0.01, generator)
    else:
        xavier_normal_(w, 1.0, generator)


# ------------------------------------------------------------------ layers


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype (float32 params)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding,
                        self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in the input's dtype. Equals flax
    `nn.ConvTranspose(padding=k-1-p, transpose_kernel=True)`."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) with flax `nn.BatchNorm(momentum=0.9)`
    semantics.

    Eval: the running statistics fold into one float32 scale and shift,
    applied in the input's dtype. Train: normalise with the batch mean and
    the *biased* batch variance over (N, H, W), in float32 (float64 for a
    float64 input), result in the input's dtype; the running statistics move by
    `ra = 0.9 * ra + 0.1 * stat`, also with the biased variance (torch's own
    update uses the unbiased one, which would drift from the JAX package's
    `batch_stats` at every step)."""

    def forward(self, x):
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        xf = upcast(x)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var * self.momentum)
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(x.dtype)


class Dropout(nn.Dropout):
    """Elementwise dropout, as flax `nn.Dropout`: kept values are scaled by
    1 / (1 - p). In train mode the mask comes from `generator`, which is
    required (a step's dropout is reproducible from its seed); in eval it is
    the identity."""

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training:
            return x
        if generator is None:
            raise ValueError("train-mode Dropout needs the step's generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


class PReLU(nn.PReLU):
    """torch nn.PReLU with one shared slope, stored as weight shape (1,)
    (the JAX package stores a scalar `alpha`)."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


_ACTIVATIONS = {"relu": nn.ReLU, "prelu": lambda: PReLU(init=0.01),
                "lrelu": lambda: nn.LeakyReLU(0.01), "sigmoid": nn.Sigmoid}


class _BlockBase(nn.Module):
    def __init__(self, layer, activation, bias, generator, norm=None):
        super().__init__()
        self.layer = layer
        init_for_activation_(layer.weight, activation, generator)
        if bias:
            nn.init.zeros_(layer.bias)
        if norm == "batch":
            self.norm = BatchNorm2d(layer.out_channels)
        elif norm is not None:
            raise NotImplementedError(f"block norm {norm!r} is not ported yet; "
                                      "see ROADMAP.md, queue 1")
        if activation is not None:
            self.act = _ACTIVATIONS[activation]()

    def forward(self, x):
        x = self.layer(x)
        if hasattr(self, "norm"):
            x = self.norm(x)
        return self.act(x) if hasattr(self, "act") else x


class ConvBlock(_BlockBase):
    """Conv -> (BatchNorm) -> (act), the kbpn BlockBase convention: ReLU /
    PReLU(0.01) / LeakyReLU(0.01) / sigmoid or none, kaiming or xavier init
    chosen by the activation."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=False,
                 activation="relu", norm=None, generator=None):
        super().__init__(Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=bias),
                         activation, bias, generator, norm)


class DeconvBlock(_BlockBase):
    """ConvTranspose -> (act); torch ConvTranspose2d(k, s, p)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=False,
                 activation="relu", generator=None):
        super().__init__(ConvTranspose2d(in_ch, out_ch, kernel_size, stride, padding,
                                         bias=bias), activation, bias, generator)


def conv2d(in_ch, out_ch, kernel_size, stride=1, padding=0, dilation=1,
           bias=True, generator=None) -> Conv2d:
    """A plain conv with flax's default init (lecun normal, zero bias)."""
    conv = Conv2d(in_ch, out_ch, kernel_size, stride, padding, dilation, bias=bias)
    lecun_normal_(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


# ------------------------------------------------- DBPN back-projection blocks


class DBPNConvBlock(nn.Module):
    """base_networks.ConvBlock: Conv (bias) -> PReLU(0.25) or none."""

    def __init__(self, in_ch, out_ch, kernel_size, stride, padding, activation="prelu",
                 generator=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=True)
        init_for_activation_(self.conv.weight, activation, generator)
        nn.init.zeros_(self.conv.bias)
        if activation is not None:
            self.act = PReLU(init=0.25)

    def forward(self, x):
        x = self.conv(x)
        return self.act(x) if hasattr(self, "act") else x


class DBPNDeconvBlock(nn.Module):
    """base_networks.DeconvBlock: ConvTranspose (bias) -> PReLU(0.25)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride, padding, generator=None):
        super().__init__()
        self.deconv = ConvTranspose2d(in_ch, out_ch, kernel_size, stride, padding, bias=True)
        init_for_activation_(self.deconv.weight, "prelu", generator)
        nn.init.zeros_(self.deconv.bias)
        self.act = PReLU(init=0.25)

    def forward(self, x):
        return self.act(self.deconv(x))


class UpBlock(nn.Module):
    """base_networks.UpBlock; with `in_ch` given, D_UpBlock: a 1x1 merge
    conv first (`conv`), from the dense concat of `in_ch` channels."""

    def __init__(self, num_filter, k=8, s=4, p=2, in_ch=None, generator=None):
        super().__init__()
        g, f = generator, num_filter
        if in_ch is not None:
            self.conv = DBPNConvBlock(in_ch, f, 1, 1, 0, generator=g)
        self.up_conv1 = DBPNDeconvBlock(f, f, k, s, p, generator=g)
        self.up_conv2 = DBPNConvBlock(f, f, k, s, p, generator=g)
        self.up_conv3 = DBPNDeconvBlock(f, f, k, s, p, generator=g)

    def forward(self, x):
        if hasattr(self, "conv"):
            x = self.conv(x)
        h0 = self.up_conv1(x)
        l0 = self.up_conv2(h0)
        h1 = self.up_conv3(l0 - x)
        return h1 + h0


class DownBlock(nn.Module):
    """base_networks.DownBlock; with `in_ch` given, D_DownBlock (see UpBlock)."""

    def __init__(self, num_filter, k=8, s=4, p=2, in_ch=None, generator=None):
        super().__init__()
        g, f = generator, num_filter
        if in_ch is not None:
            self.conv = DBPNConvBlock(in_ch, f, 1, 1, 0, generator=g)
        self.down_conv1 = DBPNConvBlock(f, f, k, s, p, generator=g)
        self.down_conv2 = DBPNDeconvBlock(f, f, k, s, p, generator=g)
        self.down_conv3 = DBPNConvBlock(f, f, k, s, p, generator=g)

    def forward(self, x):
        if hasattr(self, "conv"):
            x = self.conv(x)
        l0 = self.down_conv1(x)
        h0 = self.down_conv2(l0)
        l1 = self.down_conv3(h0 - x)
        return l1 + l0


# -------------------------------------------------------- SFT conditioning


class SFTLayer(nn.Module):
    """kbpn SFT layer over concat(features, condition map):
    features * sigmoid(conv(lrelu(conv(cat)))) + conv(lrelu(conv(cat)))."""

    def __init__(self, feat_ch, cond_ch, generator=None):
        super().__init__()
        c = feat_ch + cond_ch
        g = generator
        self.SFT_scale_conv0 = conv2d(c, c, 3, padding=1, generator=g)
        self.SFT_scale_conv1 = conv2d(c, feat_ch, 3, padding=1, generator=g)
        self.SFT_shift_conv0 = conv2d(c, c, 3, padding=1, generator=g)
        self.SFT_shift_conv1 = conv2d(c, feat_ch, 3, padding=1, generator=g)

    def forward(self, features, conditions):
        x = torch.cat([features, conditions], dim=1)
        scale = torch.sigmoid(self.SFT_scale_conv1(F.leaky_relu(self.SFT_scale_conv0(x), 0.1)))
        shift = self.SFT_shift_conv1(F.leaky_relu(self.SFT_shift_conv0(x), 0.1))
        return features * scale + shift


def _sft_branch(in_ch, out_ch, final_act, generator):
    """Two BlockBase convs with bias, no norm: (in -> in, PReLU) then
    (in -> out, final_act)."""
    return nn.Sequential(
        ConvBlock(in_ch, in_ch, 3, 1, 1, bias=True, activation="prelu", generator=generator),
        ConvBlock(in_ch, out_ch, 3, 1, 1, bias=True, activation=final_act, generator=generator))


class SFTLikeBlock(nn.Module):
    """SFT from concat(features, conditions): x * scale + shift."""

    def __init__(self, in_ch, cond_ch, features, generator=None):
        super().__init__()
        self.conv_scale = _sft_branch(in_ch + cond_ch, features, "sigmoid", generator)
        self.conv_shift = _sft_branch(in_ch + cond_ch, features, None, generator)

    def forward(self, x, cond):
        cat = torch.cat([x, cond], dim=1)
        return x * self.conv_scale(cat) + self.conv_shift(cat)


class SFTBlock(nn.Module):
    """SFT from the conditions alone: x * scale(cond) + shift(cond)."""

    def __init__(self, cond_ch, features, generator=None):
        super().__init__()
        self.conv_scale = _sft_branch(cond_ch, features, "sigmoid", generator)
        self.conv_shift = _sft_branch(cond_ch, features, None, generator)

    def forward(self, x, cond):
        return x * self.conv_scale(cond) + self.conv_shift(cond)


# ------------------------------------------------ pooling with indices


def max_pool_with_indices(x: torch.Tensor, window: int = 2):
    """Max pool (stride = window) returning window-local argmax indices, as
    the JAX package: x (B, C, H, W) with H, W divisible by `window`;
    indices in [0, window^2) in row-major window order, a tie going to the
    first position (torch.argmax and jnp.argmax agree on that). The value is
    an `amax`, whose gradient splits equally between tied positions, as
    jnp.max's does (F.max_pool2d's goes to its one index instead)."""
    b, c, h, w = x.shape
    xw = x.reshape(b, c, h // window, window, w // window, window)
    xw = xw.permute(0, 1, 2, 4, 3, 5).reshape(b, c, h // window, w // window, window * window)
    return xw.amax(dim=-1), xw.argmax(dim=-1)


def max_unpool(pooled: torch.Tensor, idx: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Inverse of max_pool_with_indices: each value at its argmax position of
    its window, zeros elsewhere (a one-hot product; no scatter)."""
    b, c, hp, wp = pooled.shape
    onehot = F.one_hot(idx, window * window).to(pooled.dtype)
    xw = (pooled[..., None] * onehot).reshape(b, c, hp, wp, window, window)
    return xw.permute(0, 1, 2, 4, 3, 5).reshape(b, c, hp * window, wp * window)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm computed in float32 (float64 for a float64 input), the
    result in the input's dtype, as flax's GroupNorm promotes its statistics."""

    def forward(self, x):
        xf = upcast(x)
        return F.group_norm(xf, self.num_groups, self.weight.to(xf.dtype),
                            self.bias.to(xf.dtype), self.eps).to(x.dtype)
