"""Blur kernels and the degradation (`csbsr_tpu/ops/blur.py`).

`batch_blur` blurs every sample with its own kernel: the pseudo-LR of
KBlock at stride 4, the degradation and the pseudo-LR loss at stride 1. It is
one grouped convolution over the batch, `groups = B * C`: a
cross-correlation with padding (k-1)//2 on each side, accumulated in float32.

The training degradation (`degrade`) blurs each HR crop with a random
anisotropic Gaussian and downsamples it bicubically by the scale factor.
`jax.random` streams cannot be reproduced in torch, so the sampler is split
in two: `gaussian_params` maps uniform draws to (theta, sigma_x, sigma_y),
and `gaussian_kernels_from` builds the kernels from them; both are held to
the JAX package exactly, and the draws come from an explicit
`torch.Generator`. Only the "gaus" blur mode, the one the shipped recipes
use, is ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .resize import resize

__all__ = ["batch_blur", "gaussian_params", "gaussian_kernels_from", "gaussian_kernels",
           "make_kernel_sampler", "identity_kernels", "degrade"]

THETA_RANGE_DEG = (0.0, 180.0)  # the rotation of the Gaussian kernels, degrees


def batch_blur(images: torch.Tensor, kernels: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """images (B, C, H, W), kernels (B, k, k) -> (B, C, H', W') in the
    images' dtype, H' = floor((H + 2p - k) / stride) + 1, p = (k - 1) // 2."""
    b, c, h, w = images.shape
    k = kernels.shape[-1]
    acc = torch.float64 if images.dtype == torch.float64 else torch.float32
    x = images.to(acc).reshape(1, b * c, h, w)
    # weight row b*C + c carries sample b's kernel for channel c
    wgt = kernels.to(acc)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    out = F.conv2d(x, wgt, stride=stride, padding=(k - 1) // 2, groups=b * c)
    return out.reshape(b, c, out.shape[-2], out.shape[-1]).to(images.dtype)


def gaussian_params(u_theta: torch.Tensor, u_sigma_x: torch.Tensor, u_sigma_y: torch.Tensor,
                    sigma_range: Tuple[float, float] = (0.2, 4.0),
                    sigma_range2: Optional[Tuple[float, float]] = None,
                    isotropic: bool = False):
    """Uniform [0, 1) draws, (B,) each -> (theta in radians, sigma_x,
    sigma_y): theta ~ U[THETA_RANGE_DEG) degrees, sigma_x ~ U[sigma_range],
    sigma_y ~ U[sigma_range2 or sigma_range] (or sigma_x when isotropic)."""
    t0, t1 = THETA_RANGE_DEG
    theta = (u_theta * (t1 - t0) + t0) * math.pi / 180.0
    a0, b0 = sigma_range
    sigma_x = u_sigma_x * (b0 - a0) + a0
    if isotropic:
        return theta, sigma_x, sigma_x
    a1, b1 = sigma_range2 if sigma_range2 else sigma_range
    return theta, sigma_x, u_sigma_y * (b1 - a1) + a1


def gaussian_kernels_from(theta: torch.Tensor, sigma_x: torch.Tensor, sigma_y: torch.Tensor,
                          size: int = 21) -> torch.Tensor:
    """Anisotropic Gaussian kernels (B, size, size), each of sum 1, on the
    integer grid [-size//2, size//2] (the reference's `GaussianBlur.make`)."""
    r = int(size / 2)
    grid = torch.linspace(-r, r, size, dtype=torch.float32, device=theta.device)
    h, v = grid[None, :].expand(size, size), grid[:, None].expand(size, size)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    sx2, sy2 = 2.0 * sigma_x**2, 2.0 * sigma_y**2
    a = (cos_t**2 / sx2 + sin_t**2 / sy2)[:, None, None]
    b = (sin_t * cos_t * (1.0 / sy2 - 1.0 / sx2))[:, None, None]
    c = (sin_t**2 / sx2 + cos_t**2 / sy2)[:, None, None]
    kern = torch.exp(-(a * h**2 + 2.0 * b * h * v + c * v**2))
    return kern / kern.sum(dim=(1, 2), keepdim=True)


def gaussian_kernels(generator: torch.Generator, batch: int, size: int = 21,
                     sigma_range=(0.2, 4.0), sigma_range2=None,
                     isotropic: bool = False) -> torch.Tensor:
    """A batch of random Gaussian kernels on the generator's device."""
    u = torch.rand((3, batch), generator=generator, device=generator.device)
    params = gaussian_params(u[0], u[1], u[2], sigma_range, sigma_range2, isotropic)
    return gaussian_kernels_from(*params, size=size)


def make_kernel_sampler(mode: str = "gaus", size: int = 21, sigma_range=(0.2, 4.0),
                        sigma_range2=None, isotropic: bool = False):
    """`sample(generator, batch) -> (batch, size, size)` for BLUR.MODE."""
    if mode != "gaus":
        raise NotImplementedError(
            f"BLUR.MODE {mode!r} is not ported yet (gaus only); see ROADMAP.md, queue 1")
    return lambda generator, batch: gaussian_kernels(
        generator, batch, size, tuple(sigma_range), sigma_range2, isotropic=isotropic)


def identity_kernels(batch: int, size: int, device=None) -> torch.Tensor:
    """Delta kernels, for BLUR.FLAG=False."""
    k = torch.zeros((batch, size, size), dtype=torch.float32, device=device)
    k[:, size // 2, size // 2] = 1.0
    return k


def degrade(hr: torch.Tensor, kernels: torch.Tensor, scale_factor: int = 4,
            method: str = "bicubic") -> torch.Tensor:
    """Per-sample blur at stride 1, then a 1/scale_factor resize.
    hr (B, C, H, W) in [0, 1], kernels (B, k, k) of sum 1."""
    blurred = batch_blur(hr, kernels)
    h, w = blurred.shape[-2:]
    return resize(blurred, (h // scale_factor, w // scale_factor), method=method)
