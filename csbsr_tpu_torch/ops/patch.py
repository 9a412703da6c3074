"""Patch split/join (`csbsr_tpu/ops/patch.py`) in NCHW.

The 7-int shape vector is the JAX package's (and the reference's):
[B, splitC, nH, nW, C, patchH, patchW].
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_patch", "joint_patch"]


def split_patch(img, patch_h: int, patch_w: int):
    """Split one (C, H, W) image into (nH*nW, C, patch_h, patch_w) patches.

    Works on numpy arrays and torch tensors alike. Remainders beyond a full
    patch are dropped, as the reference's unfold does. Returns (patches,
    unfold_shape) with unfold_shape = [1, 1, nH, nW, C, patch_h, patch_w].
    """
    c, h, w = img.shape
    nh, nw = h // patch_h, w // patch_w
    if nh == 0 or nw == 0:
        raise ValueError(
            f"image {h}x{w} is smaller than the patch {patch_h}x{patch_w}; "
            f"set INPUT.IMAGE_SIZE <= scale_factor * image size"
        )
    x = img[:, : nh * patch_h, : nw * patch_w].reshape(c, nh, patch_h, nw, patch_w)
    perm = (1, 3, 0, 2, 4)  # nh, nw, c, ph, pw
    x = x.permute(perm) if isinstance(x, torch.Tensor) else x.transpose(perm)
    patches = x.reshape(nh * nw, c, patch_h, patch_w)
    unfold_shape = np.array([1, 1, nh, nw, c, patch_h, patch_w], dtype=np.int64)
    return patches, unfold_shape


def joint_patch(patches: torch.Tensor, unfold_shape) -> torch.Tensor:
    """Inverse of split_patch for a batch of images' patches:
    (B*nH*nW, C, ph, pw) -> (B, C, nH*ph, nW*pw). The patch H/W entries of
    unfold_shape may have been scaled by the SR factor."""
    _, _, nh, nw, c, ph, pw = [int(v) for v in unfold_shape]
    x = patches.reshape(-1, nh, nw, c, ph, pw)
    x = x.permute(0, 3, 1, 4, 2, 5)  # b, c, nh, ph, nw, pw
    return x.reshape(-1, c, nh * ph, nw * pw)
