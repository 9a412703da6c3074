"""Offline test-set degrader (`csbsr_tpu/data/make_test_blur.py`).

For each HR image: one anisotropic Gaussian kernel (sigma in [0.2, 4.0]^2,
k = 21) drawn by `ops/blur.gaussian_kernels` from a `torch.Generator` seeded
with --seed, written to <out>/kernels/<name>.png (max-normalised 8-bit); the
image blurred by it to <out>/hr_images/ and its clipped bicubic 1/scale
downsampling to <out>/lr_images/: the layout CrackDataSetTest reads. The JAX
package draws its kernels from threefry, so the two packages' kernels
differ; given the same kernels they write the same images.

    python -m csbsr_tpu_torch.data.make_test_blur <hr_dir> <output_dir>
        [--glob '*.jpg'] [--seed 5] [--kernel-size 21] [--scale 4] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ..ops.blur import batch_blur, gaussian_kernels
from ..ops.resize import resize
from ..utils.device import resolve_device


def _u8(arr: np.ndarray) -> np.ndarray:
    return (np.clip(arr, 0.0, 1.0) * 255).round().astype(np.uint8)


def make_test_blur_dir(dataset_dir: str, output_dir: str, pattern: str = "*.jpg",
                       seed: int = 5, kernel_size: int = 21, scale_factor: int = 4,
                       sigma_range=(0.2, 4.0), device=None, kernels=None) -> int:
    """Degrade every `pattern` image of `dataset_dir` into `output_dir`;
    returns the count. `kernels` (one (k, k) kernel of sum 1 per image, in
    file-name order) replaces the seeded draws."""
    from PIL import Image

    dev = resolve_device(device)
    fnames = sorted(p.name for p in Path(dataset_dir).glob(pattern))
    assert fnames, f"no {pattern} images under {dataset_dir}"
    for sub in ("kernels", "hr_images", "lr_images"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i, fname in enumerate(fnames):
        img = np.asarray(Image.open(os.path.join(dataset_dir, fname))).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        if kernels is None:
            k = gaussian_kernels(gen, 1, kernel_size, tuple(sigma_range))
        else:
            k = torch.as_tensor(np.asarray(kernels[i], np.float32), device=dev)[None]
        hr = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None].to(dev)
        hr_blur = batch_blur(hr, k, stride=1)
        h, w = hr_blur.shape[-2:]
        lr = resize(hr_blur, (int(h / scale_factor), int(w / scale_factor)),
                    method="bicubic").clamp(0.0, 1.0)
        out_name = fname.replace("jpg", "png")
        kern = k[0].cpu().numpy()
        Image.fromarray(_u8(kern / kern.max()), "L").save(
            os.path.join(output_dir, "kernels", out_name))
        for sub, arr in (("hr_images", hr_blur[0]), ("lr_images", lr[0])):
            Image.fromarray(_u8(arr.permute(1, 2, 0).cpu().numpy()), "RGB").save(
                os.path.join(output_dir, sub, out_name))
    return len(fnames)


def main(argv=None):
    p = argparse.ArgumentParser(description="degrade a test set (blur + bicubic downsampling)")
    p.add_argument("dataset_dir")
    p.add_argument("output_dir")
    p.add_argument("--glob", default="*.jpg")
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--kernel-size", type=int, default=21)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n = make_test_blur_dir(args.dataset_dir, args.output_dir, args.glob, args.seed,
                           args.kernel_size, args.scale, device=args.device)
    print(f"degraded {n} images -> {args.output_dir}")


if __name__ == "__main__":
    main()
