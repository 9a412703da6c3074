"""Pairwise (image, mask) transforms on (H, W, C) numpy arrays
(`csbsr_tpu/data/transforms.py`).

`TrainTransforms` builds the chain from cfg.DATASET.DATA_AUGMENTATION and
scales by 1/255 at the end; every random choice is drawn from the sample's
`np.random.RandomState`, in the JAX package's order, so a seeded run gives
the same crops bit for bit. Ported: the flagship recipe's chain,
ConvertFromInts, RandomMirror, ToTensor, RandomVerticalFlip and RandomCrop;
the other entries raise.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TrainTransforms", "TestTransforms"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, mask, rng):
        for t in self.transforms:
            img, mask = t(img, mask, rng)
        return img, mask


class ConvertFromInts:
    def __call__(self, img, mask, rng):
        return img.astype(np.float32), (mask.astype(np.float32) if mask is not None else None)


class ToTensor:
    """Kept for config parity: the layout stays HWC until the loader."""

    def __call__(self, img, mask, rng):
        return img, mask


class RandomMirror:
    def __call__(self, img, mask, rng):
        if rng.randint(2):
            img = img[:, ::-1].copy()
            mask = mask[:, ::-1].copy() if mask is not None else None
        return img, mask


class RandomVerticalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, mask, rng):
        if rng.rand() < self.p:
            img = img[::-1].copy()
            mask = mask[::-1].copy() if mask is not None else None
        return img, mask


class RandomCrop:
    """torchvision RandomCrop at a fixed (H, W); smaller images are
    zero-padded at the bottom/right first."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, mask, rng):
        th, tw = self.size
        h, w = img.shape[:2]
        if h < th or w < tw:
            pad = ((0, max(th - h, 0)), (0, max(tw - w, 0)), (0, 0))
            img = np.pad(img, pad)
            mask = np.pad(mask, pad) if mask is not None else None
            h, w = img.shape[:2]
        i = rng.randint(0, h - th + 1)
        j = rng.randint(0, w - tw + 1)
        img = img[i: i + th, j: j + tw]
        mask = mask[i: i + th, j: j + tw] if mask is not None else None
        return img, mask


_REGISTRY = {"ConvertFromInts": ConvertFromInts, "ToTensor": ToTensor,
             "RandomMirror": RandomMirror, "RandomVerticalFlip": RandomVerticalFlip,
             "RandomCrop": RandomCrop}


class TrainTransforms:
    """The config's augmentation chain, then /255."""

    def __init__(self, cfg):
        comp = []
        size = tuple(cfg.INPUT.IMAGE_SIZE)
        for entry in cfg.DATASET.DATA_AUGMENTATION:
            func, args = entry[0], entry[1] if len(entry) > 1 else None
            if func not in _REGISTRY:
                raise NotImplementedError(
                    f"augmentation {func!r} is not ported yet; see ROADMAP.md, queue 1")
            cls = _REGISTRY[func]
            if func == "RandomCrop":
                comp.append(cls(size))
            elif func == "RandomVerticalFlip" and args not in (None, "None"):
                comp.append(cls(p=args["p"] if isinstance(args, dict) else float(args)))
            else:
                comp.append(cls())
        self.augment = Compose(comp)

    def __call__(self, image, mask, rng):
        image, mask = self.augment(image, mask, rng)
        return image / 255.0, (mask / 255.0 if mask is not None else None)


class TestTransforms:
    """ConvertFromInts + /255, on (H, W, C) uint8 arrays."""

    def __init__(self, cfg=None):
        pass

    def __call__(self, image, mask, rng=None):
        image = image.astype(np.float32) / 255.0
        mask = mask.astype(np.float32) / 255.0 if mask is not None else None
        return image, mask
