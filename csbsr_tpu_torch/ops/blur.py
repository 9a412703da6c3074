"""Blur kernels and the degradation (`csbsr_tpu/ops/blur.py`).

`batch_blur` blurs every sample with its own kernel: the pseudo-LR of
KBlock at stride 4, the degradation and the pseudo-LR loss at stride 1. It is
one grouped convolution over the batch, `groups = B * C`: a
cross-correlation with padding (k-1)//2 on each side, accumulated in float32.

The training degradation (`degrade`) blurs each HR crop with a random
kernel and downsamples it bicubically by the scale factor. The kernel
families of BLUR.MODE: the anisotropic Gaussian ("gaus", the shipped
recipes'), the filled disk ("disk"), the rotated line ("motion"), "all_rand"
(motion convolved with a Gaussian or a disk, chosen per sample) and the
compounds "<a>-<b>" (family a convolved with family b).

`jax.random` streams cannot be reproduced in torch, so each family is split
in two: a `*_params` function maps uniform [0, 1) draws to the family's
parameters (theta and the sigmas; the disk's det; the motion angle and its
odd length), and a `*_from` function builds the kernels from the
parameters. Both are held to the JAX package, and the draws come from an
explicit `torch.Generator`: `kernels_from_draws(mode, u)` takes a
(draws_per_sample(mode), B) block of them, laid out as the JAX package
splits its keys.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .resize import resize

__all__ = ["batch_blur", "gaussian_params", "gaussian_kernels_from", "gaussian_kernels",
           "disk_params", "disk_kernel_from", "motion_params", "motion_kernel_from",
           "kernel_compound", "draws_per_sample", "kernels_from_draws", "make_kernel_sampler",
           "identity_kernels", "degrade"]

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


def disk_params(u: torch.Tensor, size: int = 21, ratio_range=(0.1, 1.0)) -> torch.Tensor:
    """Uniform draws (B,) -> the disk's det = round(size * U[ratio_range])
    (ties to even, as jnp.round)."""
    a, b = ratio_range
    return torch.round(size * (u * (b - a) + a))


def disk_kernel_from(det: torch.Tensor, size: int = 21) -> torch.Tensor:
    """Filled disks (B, size, size) of sum 1 from det (B,): radius
    max(det, 1) / 2 + 0.5, pixel (r, c) inside iff its squared distance
    from (size // 2, size // 2) is below radius^2 (the reference's
    skimage.draw.disk rasterisation)."""
    det = det.float().clamp_min(1.0)
    radius = det / 2.0 + 0.5
    cc = int(size / 2)
    r = torch.arange(size, dtype=torch.float32, device=det.device)
    d2 = (r[:, None] - cc) ** 2 + (r[None, :] - cc) ** 2
    kern = (d2[None] < (radius**2)[:, None, None]).float()
    return kern / kern.sum(dim=(1, 2), keepdim=True)


def motion_params(u_deg: torch.Tensor, u_len: torch.Tensor, u_parity: torch.Tensor,
                  size: int = 21, ratio_range=(0.1, 1.0)):
    """Uniform draws (B,) each -> (deg in [0, 180), odd length): det =
    max(round(size * U[ratio_range]), 1); an even det moves by -1 where
    u_parity < 0.5 (the JAX package's Bernoulli(0.5)) and by +1 elsewhere;
    the length is clipped to [1, the largest odd length <= size]."""
    deg = 180.0 * u_deg
    det = disk_params(u_len, size, ratio_range).clamp_min(1.0)
    bump = torch.where(u_parity < 0.5, -1.0, 1.0)
    length = torch.where(torch.remainder(det, 2.0) == 0.0, det + bump, det)
    return deg, length.clamp(1.0, float(size if size % 2 == 1 else size - 1))


def _motion_bases(size: int, device) -> torch.Tensor:
    """The four quadrant bases: [0, 45) the centre row, [45, 90) the
    anti-diagonal, [90, 135) the centre column, [135, 180) the diagonal."""
    c = int((size - 1) / 2)
    bases = torch.zeros((4, size, size), dtype=torch.float32, device=device)
    bases[0, c, :] = 1.0
    bases[1] = torch.eye(size, device=device).flip(0)
    bases[2, :, c] = 1.0
    bases[3] = torch.eye(size, device=device)
    return bases


def motion_kernel_from(deg: torch.Tensor, length: torch.Tensor, size: int = 21) -> torch.Tensor:
    """Motion kernels (B, size, size) of sum 1 from the angle in degrees and
    the odd line length (B,) each: the quadrant's base rotated CCW about the
    pixel centre by the residual angle (inverse-map bilinear sampling with a
    zero border: cv2.warpAffine INTER_LINEAR in exact float arithmetic, as in
    the JAX package), cut to the central length x length square."""
    deg, length = deg.float(), length.float()
    b = deg.shape[0]
    q = torch.floor(deg / 45.0).clamp(0.0, 3.0).long()
    residual = (deg - 45.0 * q) * math.pi / 180.0
    flat = _motion_bases(size, deg.device)[q].reshape(b, size * size)

    c = (size - 1) / 2.0
    coord = torch.arange(size, dtype=torch.float32, device=deg.device)
    x, y = coord[None, None, :], coord[None, :, None]
    alpha, beta = torch.cos(residual)[:, None, None], torch.sin(residual)[:, None, None]
    sx = alpha * (x - c) - beta * (y - c) + c
    sy = beta * (x - c) + alpha * (y - c) + c
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0

    def gather(yy, xx):
        inb = (yy >= 0) & (yy < size) & (xx >= 0) & (xx < size)
        idx = yy.clamp(0, size - 1).long() * size + xx.clamp(0, size - 1).long()
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, size, size) * inb

    rot = (gather(y0, x0) * (1 - fx) * (1 - fy) + gather(y0, x0 + 1) * fx * (1 - fy)
           + gather(y0 + 1, x0) * (1 - fx) * fy + gather(y0 + 1, x0 + 1) * fx * fy)
    margin = torch.round((size - length) / 2.0)[:, None]
    in_span = (coord[None, :] >= margin) & (coord[None, :] < margin + length[:, None])
    kern = rot * (in_span[:, :, None] & in_span[:, None, :])
    return kern / kern.sum(dim=(1, 2), keepdim=True)


def kernel_compound(kernel_a: torch.Tensor, kernel_b: torch.Tensor) -> torch.Tensor:
    """Per sample, kernel_a cross-correlated with kernel_b (zero padding
    (k_b - 1) // 2, the size of kernel_a), renormalised to sum 1: one grouped
    convolution over the batch."""
    b, k, _ = kernel_a.shape
    kb = kernel_b.shape[-1]
    out = F.conv2d(kernel_a.reshape(1, b, k, k), kernel_b.reshape(b, 1, kb, kb),
                   padding=(kb - 1) // 2, groups=b).reshape(b, k, k)
    return out / out.sum(dim=(1, 2), keepdim=True)


# uniform draws per sample of each family: gaus (theta, sigma_x, sigma_y),
# disk (det), motion (angle, length, parity)
_FAMILY_DRAWS = {"gaus": 3, "disk": 1, "motion": 3}


def _families(mode: str):
    """The families a mode draws, in the order of its draws."""
    if mode in _FAMILY_DRAWS:
        return [mode]
    if mode == "all_rand":  # the selector's draw comes first
        return ["motion", "gaus", "disk"]
    if "-" in mode:
        names = mode.split("-")
        if len(names) == 2 and all(n in _FAMILY_DRAWS for n in names):
            return names
    raise ValueError(f"unknown blur mode {mode!r}")


def draws_per_sample(mode: str) -> int:
    return (mode == "all_rand") + sum(_FAMILY_DRAWS[f] for f in _families(mode))


def kernels_from_draws(mode: str, u: torch.Tensor, size: int = 21, sigma_range=(0.2, 4.0),
                       sigma_range2=None, ratio_range=(0.1, 1.0),
                       isotropic: bool = False) -> torch.Tensor:
    """BLUR.MODE's kernels (B, size, size) from u, (draws_per_sample(mode), B)
    uniform [0, 1) draws: per family its draws in `_FAMILY_DRAWS` order, the
    families in `_families` order; "all_rand" first draws its selector
    (u < 0.5: the Gaussian, else the disk)."""
    def family(name, v):
        if name == "gaus":
            return gaussian_kernels_from(*gaussian_params(
                v[0], v[1], v[2], tuple(sigma_range), sigma_range2, isotropic), size=size)
        if name == "disk":
            return disk_kernel_from(disk_params(v[0], size, ratio_range), size)
        return motion_kernel_from(*motion_params(v[0], v[1], v[2], size, ratio_range), size)

    rows = iter(u[1:] if mode == "all_rand" else u)
    kerns = [family(f, [next(rows) for _ in range(_FAMILY_DRAWS[f])]) for f in _families(mode)]
    if mode == "all_rand":
        motion, gaus, disk = kerns
        return kernel_compound(motion, torch.where((u[0] < 0.5)[:, None, None], gaus, disk))
    return kerns[0] if len(kerns) == 1 else kernel_compound(*kerns)


def make_kernel_sampler(mode: str = "gaus", size: int = 21, sigma_range=(0.2, 4.0),
                        sigma_range2=None, ratio_range=(0.1, 1.0), isotropic: bool = False):
    """`sample(generator, batch) -> (batch, size, size)` for BLUR.MODE, on
    the generator's device."""
    n = draws_per_sample(mode)

    def sample(generator, batch):
        u = torch.rand((n, batch), generator=generator, device=generator.device)
        return kernels_from_draws(mode, u, size, sigma_range, sigma_range2, ratio_range,
                                  isotropic)

    return sample


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
