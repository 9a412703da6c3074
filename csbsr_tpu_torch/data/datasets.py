"""Crack test dataset (`csbsr_tpu/data/datasets.py:CrackDataSetTest`).

Reads the GT image and mask, the precomputed blurred LR and the GT kernel
(under <blur_dir>/<name>/{lr_images,kernels}) and cuts the LR into patches.
Arrays come out NCHW: patches (N, 3, h, w), SR target (3, H, W), seg target
(1, H, W), kernels (N, k, k). PIL is imported only where a file is read.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List

import numpy as np

from .transforms import TestTransforms
from ..ops.patch import split_patch


def _imread(path) -> np.ndarray:
    from PIL import Image

    arr = np.array(Image.open(path))
    return arr[:, :, None] if arr.ndim == 2 else arr


def _chw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (2, 0, 1)))


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
