"""Crack datasets (`csbsr_tpu/data/datasets.py`).

Train side: `CrackDataSet` (jpg image + same-name mask),
`SyntheticCrackDataSet` (deterministic crack-like strokes, for runs without
the data) and `SubsetView` (the seeded train/eval split). Their items are
(image (H, W, 3), mask (H, W, 1)) float32 numpy, exactly the JAX package's;
the loader stacks them into NCHW batches. Degradation runs on the device in
the train step.

Test side: `CrackDataSetTest` reads the GT image and mask, the precomputed
blurred LR and the GT kernel (under <blur_dir>/<name>/{lr_images,kernels})
and cuts the LR into patches. Arrays come out NCHW: patches (N, 3, h, w), SR
target (3, H, W), seg target (1, H, W), kernels (N, k, k).

PIL is imported only where a file is read.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .transforms import TestTransforms, TrainTransforms
from ..ops.patch import split_patch


def _imread(path) -> np.ndarray:
    from PIL import Image

    arr = np.array(Image.open(path))
    return arr[:, :, None] if arr.ndim == 2 else arr


def _chw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (2, 0, 1)))


class CrackDataSet:
    """Train dataset: <image_dir>/*.jpg with the same-name mask in seg_dir."""

    def __init__(self, cfg, image_dir, seg_dir, transforms: TrainTransforms):
        self.image_dir, self.seg_dir = image_dir, seg_dir
        self.fnames: List[str] = sorted(p.name for p in Path(image_dir).glob("*.jpg"))
        self.transforms = transforms

    def __len__(self):
        return len(self.fnames)

    def get(self, i: int, rng: np.random.RandomState):
        fname = self.fnames[i]
        img = _imread(os.path.join(self.image_dir, fname))
        seg = _imread(os.path.join(self.seg_dir, fname))[:, :, :1]
        img, seg = self.transforms(img, seg, rng)
        return img.astype(np.float32), seg.astype(np.float32)


class SyntheticCrackDataSet:
    """Deterministic stand-in: per index, a textured image darkened along
    three random polylines and their mask (the rng argument is unused)."""

    def __init__(self, cfg, size: int = 64, image_hw: Tuple[int, int] = (224, 224)):
        self.size = size
        self.hw = tuple(image_hw)

    def __len__(self):
        return self.size

    def get(self, i: int, rng=None):
        h, w = self.hw
        local = np.random.RandomState(i * 9973 + 11)
        img = local.rand(h, w, 3).astype(np.float32) * 0.3 + 0.4
        seg = np.zeros((h, w, 1), np.float32)
        for _ in range(3):
            x, y = local.randint(0, w), local.randint(0, h)
            dx, dy = local.randn(2)
            for _ in range(200):
                xi, yi = int(x) % w, int(y) % h
                seg[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2, 0] = 1.0
                img[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2] *= 0.35
                dx += 0.3 * local.randn()
                dy += 0.3 * local.randn()
                n = max(np.hypot(dx, dy), 1e-6)
                x += dx / n
                y += dy / n
        return img, seg


class SubsetView:
    """Index-restricted view of a train dataset (the seeded 95/5 split)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, i, rng=None):
        return self.dataset.get(self.indices[i], rng)


class CrackDataSetTest:
    def __init__(self, cfg, image_dir, seg_dir, blur_dir, blur_name):
        self.gt_image_dir = image_dir
        self.gt_seg_dir = seg_dir
        self.gt_blur_dir = os.path.join(blur_dir, blur_name, "kernels")
        self.input_image_dir = os.path.join(blur_dir, blur_name, "lr_images")
        self.fnames: List[str] = sorted(p.name for p in Path(image_dir).glob("*.jpg"))
        self.transforms = TestTransforms(cfg)
        self.scale_factor = cfg.MODEL.SCALE_FACTOR
        self.patch_h, self.patch_w = [int(i / self.scale_factor) for i in cfg.INPUT.IMAGE_SIZE]

    def __len__(self):
        return len(self.fnames)

    def get(self, i: int):
        """-> (patches, sr_target, seg_target, kernels, fname, img_ushape, seg_ushape)."""
        fname = self.fnames[i]
        sr_target = _imread(os.path.join(self.gt_image_dir, fname))
        seg_target = _imread(os.path.join(self.gt_seg_dir, fname))[:, :, :1]
        sr_target, seg_target = self.transforms(sr_target, seg_target)

        kname = fname.replace("jpg", "png")
        kernel = _imread(os.path.join(self.gt_blur_dir, kname)).astype(np.float32) / 255.0
        kernel = kernel[:, :, 0]
        kernel = kernel / kernel.sum()

        if self.scale_factor != 1:
            lr, _ = self.transforms(_imread(os.path.join(self.input_image_dir, kname)), None)
        else:
            lr = sr_target

        patches, ushape = split_patch(_chw(lr), self.patch_h, self.patch_w)
        ushape[[5, 6]] = ushape[[5, 6]] * self.scale_factor
        seg_ushape = ushape.copy()
        seg_ushape[4] = 1
        num_patch = int(ushape[2] * ushape[3])
        kernels = np.broadcast_to(kernel, (num_patch, *kernel.shape)).copy()
        return (
            np.ascontiguousarray(patches, dtype=np.float32),
            _chw(sr_target.astype(np.float32)),
            _chw(seg_target.astype(np.float32)),
            kernels.astype(np.float32),
            fname,
            ushape,
            seg_ushape,
        )
