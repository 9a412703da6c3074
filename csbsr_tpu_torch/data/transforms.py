"""Test-time transforms (`csbsr_tpu/data/transforms.py:TestTransforms`)."""
from __future__ import annotations

import numpy as np


class TestTransforms:
    """ConvertFromInts + /255, on (H, W, C) uint8 arrays."""

    def __init__(self, cfg=None):
        pass

    def __call__(self, image, mask, rng=None):
        image = image.astype(np.float32) / 255.0
        mask = mask.astype(np.float32) / 255.0 if mask is not None else None
        return image, mask
