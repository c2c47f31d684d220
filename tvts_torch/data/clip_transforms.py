"""Clip-level transform classes (counterpart of tvts_tpu/data/clip_transforms.py;
reference v2/video_transforms/video_transform.py:24-664), with no PIL.

The torchvision-style library of clip ops, applied alike to every frame of a
numpy [T, H, W, C] uint8 clip (ClipToTensor converts to float [T, C, H, W]).
The JAX package runs the per-frame ops through Pillow; here each is Pillow's
arithmetic in numpy on all frames at once, bit for bit the Pillow call
(tests/test_torch_frozen.py holds each class to the JAX module's):
- `Resize`: Image.resize with NEAREST, BILINEAR or BICUBIC
  (data/transforms.resize);
- `RandomRotation`: Image.rotate(angle) with NEAREST, no expand and a black
  fill (downstream/randaug.py's `_rotate` over Geometry.c's nearest affine);
- `ColorJitter`: ImageEnhance Brightness, Contrast and Color
  (downstream/randaug.py's blends), then the hue shift through Convert.c's
  RGB -> HSV -> RGB (`rgb_to_hsv`, `hsv_to_rgb`: its float and double
  arithmetic, step by step).
Randomness is the JAX module's: the stdlib `random` calls (or ColorJitter's
injected numpy Generator) in the same order.
"""

from __future__ import annotations

import numbers
import random as _random

import numpy as np

from tvts_torch.data.transforms import (
    BICUBIC,
    BILINEAR,
    IMAGENET_MEAN,
    IMAGENET_STD,
    NEAREST,
    resize,
)
from tvts_torch.downstream.randaug import _brightness, _color, _contrast, _rotate

_RESAMPLE = {"nearest": NEAREST, "bilinear": BILINEAR, "bicubic": BICUBIC}


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip


class Resize:
    """Shorter-side (int size) or exact (h, w) resize; 'nearest' default matches
    the reference (video_transform.py:171-189)."""

    def __init__(self, size, interpolation="nearest"):
        self.size = size
        self.resample = _RESAMPLE[interpolation]

    def __call__(self, clip):
        h, w = clip.shape[1:3]
        if isinstance(self.size, numbers.Number):
            size = int(self.size)
            if (w <= h and w == size) or (h <= w and h == size):
                return clip
            if w < h:
                ow, oh = size, int(size * h / w)
            else:
                oh, ow = size, int(size * w / h)
        else:
            oh, ow = self.size
        return resize(clip, (ow, oh), self.resample)


class RandomResize:
    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0), interpolation="nearest"):
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, clip):
        scale = _random.uniform(*self.ratio)
        h, w = clip.shape[1:3]
        return Resize((int(h * scale), int(w * scale)), self.interpolation)(clip)


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, clip):
        h, w = self.size
        ih, iw = clip.shape[1:3]
        if w > iw or h > ih:
            raise ValueError("crop larger than clip")
        y = _random.randint(0, ih - h)
        x = _random.randint(0, iw - w)
        return clip[:, y: y + h, x: x + w]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, clip):
        h, w = self.size
        ih, iw = clip.shape[1:3]
        y = int(round((ih - h) / 2.0))
        x = int(round((iw - w) / 2.0))
        return clip[:, y: y + h, x: x + w]


class CornerCrop:
    """Crop one of 5 positions (4 corners + center), random if not fixed
    (reference video_transform.py:235-286)."""

    POSITIONS = ("c", "tl", "tr", "bl", "br")

    def __init__(self, size, crop_position=None):
        self.size = size
        self.crop_position = crop_position

    def __call__(self, clip):
        s = self.size
        ih, iw = clip.shape[1:3]
        pos = self.crop_position or _random.choice(self.POSITIONS)
        if pos == "c":
            y, x = (ih - s) // 2, (iw - s) // 2
        elif pos == "tl":
            y, x = 0, 0
        elif pos == "tr":
            y, x = 0, iw - s
        elif pos == "bl":
            y, x = ih - s, 0
        else:
            y, x = ih - s, iw - s
        return clip[:, y: y + s, x: x + s]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip):
        if _random.random() < self.p:
            return clip[:, :, ::-1].copy()
        return clip


class RandomRotation:
    def __init__(self, degrees):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def __call__(self, clip):
        angle = _random.uniform(*self.degrees)
        return _rotate(clip, angle, resample=NEAREST, fillcolor=0)


# ---------------------------------------------------------------------------
# Convert.c's RGB <-> HSV (its float and double arithmetic)
# ---------------------------------------------------------------------------
def rgb_to_hsv(frames: np.ndarray) -> np.ndarray:
    """Image.convert("HSV") of [..., 3] uint8 RGB (Convert.c rgb2hsv_row)."""
    r, g, b = (frames[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(maxc == 0, 1, maxc).astype(np.float32)
    rc, gc, bc = ((maxc - c).astype(np.float32) / cr for c in (r, g, b))
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, (2.0 + rc.astype(np.float64) - bc).astype(np.float32),
                          (4.0 + gc.astype(np.float64) - rc).astype(np.float32)))
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip(np.trunc(h.astype(np.float64) * 255.0), 0, 255)
    us = np.clip(np.trunc(s.astype(np.float64) * 255.0), 0, 255)
    return np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], -1).astype(np.uint8)


def _round_half_up(x: np.ndarray) -> np.ndarray:
    """C round() of x >= 0: halves away from zero."""
    floor = np.floor(x)
    return floor + (x - floor >= 0.5)


def hsv_to_rgb(frames: np.ndarray) -> np.ndarray:
    """Image.convert("RGB") of [..., 3] uint8 HSV (Convert.c hsv2rgb)."""
    h, s, v = (frames[..., i] for i in range(3))
    hf = h.astype(np.float32).astype(np.float64) * 6.0 / 255.0
    i = np.floor(hf)
    f = (hf - i.astype(np.float32)).astype(np.float32)
    fs = (s.astype(np.float32).astype(np.float64) / 255.0).astype(np.float32)
    vd = v.astype(np.float32).astype(np.float64)

    def u8(x):
        return np.clip(_round_half_up(x), 0, 255).astype(np.uint8)

    p = u8(vd * (1.0 - fs.astype(np.float64)))
    q = u8(vd * (1.0 - (fs * f).astype(np.float64)))
    t = u8(vd * (1.0 - fs.astype(np.float64) * (1.0 - f.astype(np.float64))))
    sector = i.astype(np.int64) % 6
    rgb = np.stack([np.choose(sector, c) for c in ((v, q, p, p, t, v), (t, v, v, q, p, p),
                                                    (p, p, t, v, v, q))], -1)
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.uint8)


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter, one sampled factor set per clip
    (reference video_transform.py:461-543)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        # an optional numpy Generator; the stdlib random otherwise
        self.rng = rng

    def _uniform(self, lo, hi):
        if self.rng is not None:
            return float(self.rng.uniform(lo, hi))
        return _random.uniform(lo, hi)

    def _factor(self, amount):
        if amount <= 0:
            return None
        return self._uniform(max(0.0, 1 - amount), 1 + amount)

    def __call__(self, clip):
        b = self._factor(self.brightness)
        c = self._factor(self.contrast)
        s = self._factor(self.saturation)
        h = self._uniform(-self.hue, self.hue) if self.hue > 0 else None
        if b is not None:
            clip = _brightness(clip, b)
        if c is not None:
            clip = _contrast(clip, c)
        if s is not None:
            clip = _color(clip, s)
        if h is not None:
            hsv = rgb_to_hsv(clip)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 256
            clip = hsv_to_rgb(hsv)
        return clip


class ClipToTensor:
    """[T, H, W, C] uint8 -> [T, C, H, W] float in [0, 1] (reference :24-75
    returns [C, T, H, W]; the frame-major layout is the models')."""

    def __init__(self, div_255: bool = True):
        self.div_255 = div_255

    def __call__(self, clip):
        x = clip.astype(np.float32)
        if self.div_255:
            x = x / 255.0
        return x.transpose(0, 3, 1, 2)


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, clip):
        return (clip - self.mean[:, None, None]) / self.std[:, None, None]
