"""A synthetic crack test set made on the device.

Masks of thin random strokes, textured images darkened along them, and LR
inputs made with the port's `batch_blur` at stride SCALE_FACTOR by a fixed
anisotropic Gaussian (KERNEL_SIZE_OUTPUT wide). Items have the layout of
CrackDataSetTest's and stay on the device, so an evaluation of them measures
the device path and not image decoding.
"""
from __future__ import annotations

import math

import torch

from ..ops.blur import batch_blur, gaussian_kernels_from
from ..ops.patch import split_patch


STROKES = 4  # random walks per image
STEPS = 400  # unit steps per walk


class SyntheticCrackSet:
    def __init__(self, cfg, n: int, size: int, device, seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        sf = cfg.MODEL.SCALE_FACTOR
        ksize = cfg.BLUR.KERNEL_SIZE_OUTPUT
        ang = torch.cumsum(0.3 * torch.randn((n, STROKES, STEPS), generator=gen, device=device), -1)
        ang = ang + 2 * math.pi * torch.rand((n, STROKES, 1), generator=gen, device=device)
        start = size * torch.rand((n, STROKES, 1, 2), generator=gen, device=device)
        pts = start + torch.cumsum(torch.stack([torch.sin(ang), torch.cos(ang)], -1), dim=2)
        pts = pts.round().long().clamp(0, size - 1)
        mask = torch.zeros((n, 1, size, size), device=device)
        img_idx = torch.arange(n, device=device)[:, None, None].expand(n, STROKES, STEPS)
        mask[img_idx, 0, pts[..., 0], pts[..., 1]] = 1.0
        mask = torch.nn.functional.max_pool2d(mask, 3, 1, 1)  # 3-px wide strokes
        noise = torch.rand((n, 3, max(size // 8, 1), max(size // 8, 1)), generator=gen,
                           device=device)
        texture = torch.nn.functional.interpolate(noise, size=(size, size), mode="bilinear")
        hr = (0.35 + 0.3 * texture) * (1.0 - 0.6 * mask)
        params = torch.tensor([[0.5], [2.0], [1.0]], device=device)  # theta, sigma_x, sigma_y
        self.kernel = gaussian_kernels_from(*params, size=ksize)[0]
        lr = batch_blur(hr, self.kernel.expand(n, ksize, ksize), stride=sf).clamp(0, 1)
        ph, pw = [s // sf for s in cfg.INPUT.IMAGE_SIZE]
        self.items = []
        for i in range(n):
            patches, ushape = split_patch(lr[i], ph, pw)
            ushape[[5, 6]] *= sf
            seg_ushape = ushape.copy()
            seg_ushape[4] = 1
            kernels = self.kernel.expand(patches.shape[0], ksize, ksize)
            self.items.append((patches.contiguous(), hr[i], mask[i], kernels, f"syn{i}.jpg",
                               ushape, seg_ushape))

    def __len__(self):
        return len(self.items)

    def get(self, i):
        """-> (patches, sr_target, seg_target, kernels, fname, img_ushape, seg_ushape)."""
        return self.items[i]
