"""Shared blocks (`csbsr_tpu/models/blocks.py`), in NCHW PyTorch.

Module and attribute names are the original CSBSR torch names, so the
state-dict keys are the ones the JAX package's translators emit and a
released reference `.pth` loads as is. The BlockBase family
(ConvBlock/DeconvBlock) keeps its conv in `.layer` and its activation in
`.act`. Only what the flagship KBPN uses is ported: no norm inside a block,
ReLU / PReLU(0.01) / LeakyReLU(0.01) or no activation.

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
                "lrelu": lambda: nn.LeakyReLU(0.01)}


class _BlockBase(nn.Module):
    def __init__(self, layer, activation, bias, generator):
        super().__init__()
        self.layer = layer
        init_for_activation_(layer.weight, activation, generator)
        if bias:
            nn.init.zeros_(layer.bias)
        if activation is not None:
            self.act = _ACTIVATIONS[activation]()

    def forward(self, x):
        x = self.layer(x)
        return self.act(x) if hasattr(self, "act") else x


class ConvBlock(_BlockBase):
    """Conv -> (act), the kbpn BlockBase convention: ReLU / PReLU(0.01) /
    LeakyReLU(0.01) or none, kaiming or xavier init chosen by the activation."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=False,
                 activation="relu", generator=None):
        super().__init__(Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=bias),
                         activation, bias, generator)


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
