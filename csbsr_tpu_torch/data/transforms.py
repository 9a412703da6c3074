"""Pairwise (image, mask) transforms on (H, W, C) numpy arrays
(`csbsr_tpu/data/transforms.py`).

`TrainTransforms` builds the chain from cfg.DATASET.DATA_AUGMENTATION and
scales by 1/255 at the end; every random choice is drawn from the sample's
`np.random.RandomState`, in the JAX package's order, so a seeded run gives
the same crops and the same photometric draws.

The JAX package calls OpenCV for two things, which the port does in numpy
(the card's machine has no OpenCV):
  - `resize_linear`, cv2.resize INTER_LINEAR: half-pixel centres, edge
    clamping, no antialias, the horizontal pass then the vertical. Float
    input is interpolated in float64 and rounded to its dtype, as cv2's
    IPP route computes it (its generic float32 route is up to 3e-3 off on
    the 0-255 scale at 300 -> 224). On uint8 input cv2 works in fixed
    point: each weight rounded to 11 bits, the horizontal pass in integers,
    the vertical one with the rounding of its vectorised code; that is
    cv2's result on most pixels and within one level on every pixel (its
    scalar tail rounds once instead of per tap). The shipped chains put
    ConvertFromInts first, so RandomResizedCrop sees float32; only a chain
    that crops before ConvertFromInts reaches the uint8 path.
  - `rgb_to_hsv` / `hsv_to_rgb`, cv2.cvtColor's float32 convention: H in
    degrees [0, 360), S in [0, 1], V in the input's scale.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TrainTransforms", "TestTransforms", "resize_linear", "rgb_to_hsv", "hsv_to_rgb"]

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS for uint8 input


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


class RandomResizedCrop:
    """torchvision RandomResizedCrop: up to ten draws of an area share in
    `scale` and a log-uniform aspect in `ratio`, the first crop that fits
    (else the whole image), resized to `size` by `resize_linear`."""

    def __init__(self, size, scale=(1.0, 1.0), ratio=(1.0, 1.0)):
        self.size, self.scale, self.ratio = size, scale, ratio

    def __call__(self, img, mask, rng):
        h, w = img.shape[:2]
        img_c, mask_c = img, mask
        for _ in range(10):
            target_area = h * w * rng.uniform(*self.scale)
            aspect = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = rng.randint(0, h - ch + 1)
                j = rng.randint(0, w - cw + 1)
                img_c = img[i: i + ch, j: j + cw]
                mask_c = mask[i: i + ch, j: j + cw] if mask is not None else None
                break
        out = resize_linear(img_c, self.size)
        return out, (resize_linear(mask_c, self.size) if mask_c is not None else None)


def _linear_taps(n_in: int, n_out: int):
    """cv2's INTER_LINEAR taps along one axis: (index, index + 1, weight of
    index + 1), float64."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    low, high = i0 < 0, i0 >= n_in - 1
    frac[low | high] = 0.0
    i0 = np.where(low, 0, np.where(high, n_in - 1, i0))
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_LINEAR) of an (H, W, C)
    array, C kept (cv2 drops a single channel; the JAX package puts it
    back); see the module docstring for the arithmetic."""
    th, tw = int(size[0]), int(size[1])
    y0, y1, fy = _linear_taps(img.shape[0], th)
    x0, x1, fx = _linear_taps(img.shape[1], tw)
    if img.dtype == np.uint8:
        one = 1 << _COEF_BITS
        # cv2 derives the fixed-point weights from float32 ones
        wx = [np.round(w.astype(np.float32) * one).astype(np.int64)[None, :, None]
              for w in (1.0 - fx, fx)]
        wy = [np.round(w.astype(np.float32) * one).astype(np.int64)[:, None, None]
              for w in (1.0 - fy, fy)]
        src = img.astype(np.int64)
        rows = src[:, x0] * wx[0] + src[:, x1] * wx[1]
        acc = (((rows[y0] >> 4) * wy[0]) >> 16) + (((rows[y1] >> 4) * wy[1]) >> 16)
        return np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8)
    src = img.astype(np.float64)
    rows = src[:, x0] * (1.0 - fx)[None, :, None] + src[:, x1] * fx[None, :, None]
    out = rows[y0] * (1.0 - fy)[:, None, None] + rows[y1] * fy[:, None, None]
    return out.astype(img.dtype)


def rgb_to_hsv(img: np.ndarray, bgr: bool = False) -> np.ndarray:
    """cv2.cvtColor(float32, COLOR_RGB2HSV) (COLOR_BGR2HSV with bgr)."""
    img = img.astype(np.float32)
    r, g, b = (img[..., 2], img[..., 1], img[..., 0]) if bgr else (
        img[..., 0], img[..., 1], img[..., 2])
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    scale = (60.0 / (diff + _FLT_EPSILON).astype(np.float64)).astype(np.float32)
    h = np.where(v == r, (g - b) * scale,
                 np.where(v == g, (b - r) * scale + np.float32(120.0),
                          (r - g) * scale + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# cv2's HSV -> RGB sector table: which of (v, p, q, t) is (b, g, r)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(img: np.ndarray, bgr: bool = False) -> np.ndarray:
    """cv2.cvtColor(float32, COLOR_HSV2RGB) (COLOR_HSV2BGR with bgr): H in
    degrees, wrapped into [0, 360)."""
    img = img.astype(np.float32)
    h, s, v = img[..., 0] * np.float32(6.0 / 360.0), img[..., 1], img[..., 2]
    h = np.fmod(h, np.float32(6.0))
    h = np.where(h < 0, h + np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0.0), h).astype(np.float32)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], axis=-1)
    pick = _SECTORS[sector]  # (..., 3): the b, g, r entries of tab
    bgr_out = np.take_along_axis(tab, pick, axis=-1)
    grey = (s == 0)[..., None]
    bgr_out = np.where(grey, v[..., None], bgr_out)
    return (bgr_out if bgr else bgr_out[..., ::-1]).astype(np.float32)


def image_clipping(image):
    """Clip to the pre-normalisation [0, 255] range."""
    return np.clip(image, 0, 255)


class RandomContrast:
    """x *= U(lower, upper) with probability 1/2, then clipped."""

    def __init__(self, lower=0.5, upper=1.5):
        assert upper >= lower >= 0
        self.lower, self.upper = lower, upper

    def __call__(self, img, mask, rng):
        if rng.randint(2):
            img = img * rng.uniform(self.lower, self.upper)
        return image_clipping(img), mask


class RandomBrightness:
    """x += U(-delta, delta) with probability 1/2, then clipped."""

    def __init__(self, delta=32):
        assert 0.0 <= delta <= 255.0
        self.delta = delta

    def __call__(self, img, mask, rng):
        if rng.randint(2):
            img = img + rng.uniform(-self.delta, self.delta)
        return image_clipping(img), mask


class _ScaleHSVChannel:
    """HSV channel `channel` *= U(lower, upper) with probability 1/2, then
    clipped."""
    channel = 0

    def __init__(self, lower=0.5, upper=1.5):
        assert upper >= lower >= 0
        self.lower, self.upper = lower, upper

    def __call__(self, img, mask, rng):
        if rng.randint(2):
            img = img.copy()
            img[:, :, self.channel] *= rng.uniform(self.lower, self.upper)
        return image_clipping(img), mask


class RandomSaturation(_ScaleHSVChannel):
    channel = 1


class RandomValue(_ScaleHSVChannel):
    channel = 2


class RandomHue:
    """HSV H += U(-delta, delta) with probability 1/2, wrapped mod 180 (the
    reference keeps OpenCV's uint8 hue range although the float H is in
    degrees; kept as it is)."""

    def __init__(self, delta=18.0):
        assert 0.0 <= delta <= 180.0
        self.delta = delta

    def __call__(self, img, mask, rng):
        if rng.randint(2):
            img = img.copy()
            img[:, :, 0] += rng.uniform(-self.delta, self.delta)
            img[:, :, 0] = img[:, :, 0] % 180
        return img, mask


class SwapChannels:
    def __init__(self, swaps):
        self.swaps = swaps

    def __call__(self, img):
        return img[:, :, self.swaps]


class RandomLightingNoise:
    """A random channel permutation with probability 1/2."""

    PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

    def __call__(self, img, mask, rng):
        if rng.randint(2):
            img = SwapChannels(self.PERMS[rng.randint(len(self.PERMS))])(img)
        return img, mask


class ConvertColor:
    """RGB/BGR <-> HSV on float arrays, as cv2.cvtColor converts them."""

    def __init__(self, current, transform):
        self.current, self.transform = current, transform

    def __call__(self, img, mask, rng=None):
        pair = (self.current, self.transform)
        if pair == ("BGR", "RGB"):
            return img[:, :, ::-1], mask
        if pair in (("RGB", "HSV"), ("BGR", "HSV")):
            return rgb_to_hsv(img, bgr=self.current == "BGR"), mask
        if pair in (("HSV", "RGB"), ("HSV", "BGR")):
            return hsv_to_rgb(img, bgr=self.transform == "BGR"), mask
        raise NotImplementedError(pair)


class PhotometricDistort:
    """Brightness, then contrast first or last around the HSV saturation,
    value and hue steps, then the channel permutation; the draws in the JAX
    package's order."""

    def __init__(self):
        self.pmd = [RandomContrast(), ConvertColor(current="RGB", transform="HSV"),
                    RandomSaturation(), RandomValue(), RandomHue(),
                    ConvertColor(current="HSV", transform="RGB"), RandomContrast()]
        self.rand_brightness = RandomBrightness()
        self.rand_light_noise = RandomLightingNoise()

    def __call__(self, img, mask, rng):
        img = np.ascontiguousarray(img, dtype=np.float32).copy()
        img, mask = self.rand_brightness(img, mask, rng)
        for t in (self.pmd[:-1] if rng.randint(2) else self.pmd[1:]):
            img, mask = t(img, mask, rng)
        return self.rand_light_noise(img, mask, rng)


_REGISTRY = {"ConvertFromInts": ConvertFromInts, "ToTensor": ToTensor,
             "RandomMirror": RandomMirror, "RandomVerticalFlip": RandomVerticalFlip,
             "RandomCrop": RandomCrop, "RandomResizedCrop": RandomResizedCrop,
             "PhotometricDistort": PhotometricDistort, "RandomContrast": RandomContrast,
             "RandomBrightness": RandomBrightness, "RandomSaturation": RandomSaturation,
             "RandomValue": RandomValue, "RandomHue": RandomHue,
             "RandomLightingNoise": RandomLightingNoise}


class TrainTransforms:
    """The config's augmentation chain, then /255."""

    def __init__(self, cfg):
        comp = []
        size = tuple(cfg.INPUT.IMAGE_SIZE)
        for entry in cfg.DATASET.DATA_AUGMENTATION:
            func, args = entry[0], entry[1] if len(entry) > 1 else None
            cls = _REGISTRY[func]
            if func == "RandomResizedCrop":
                kw = args[0] if isinstance(args, list) else (args or {})
                comp.append(cls(size, **{k: tuple(v) if isinstance(v, (list, tuple)) else v
                                         for k, v in dict(kw).items()}))
            elif func == "RandomCrop":
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
