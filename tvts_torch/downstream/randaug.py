"""RandAugment for video clips in numpy (counterpart of
tvts_tpu/downstream/randaug.py), with no PIL.

The JAX package applies timm's RandAugment (reference
v1/downstream/rand_augment.py) through Pillow, one image a frame, the same op
and arguments on every frame of a clip. Here every op is Pillow's arithmetic
written out in numpy on uint8 [..., H, W, 3] frames, all frames at once, bit
for bit the Pillow call (tests/test_torch_randaug.py holds each op to the JAX
module's on PIL frames):
- lookup tables (`Invert`, `Posterize`, `Solarize`, `SolarizeAdd`) and
  ImageOps' per-channel histogram tables (`AutoContrast`, `Equalize`; a
  table value past 255 clipped as Image.point clips it), a histogram a frame;
- the ImageEnhance ops are Image.blend(degenerate, image, factor) in C
  float arithmetic (Blend.c): in1 + factor * (in2 - in1) truncated, with
  the result clipped to [0, 255] outside 0 <= factor <= 1. The degenerate
  image: `Color` the frame through "L" (ITU-R 601-2 in 16-bit fixed point,
  Convert.c) and back; `Contrast` a flat frame at int(mean of L + 0.5);
  `Brightness` black; `Sharpness` ImageFilter.SMOOTH (3x3 1,1,1 / 1,5,1 /
  1,1,1 over 13, rounded to nearest, the border rows and columns copied,
  Filter.c);
- the geometric ops are Image.transform(AFFINE) with BILINEAR or BICUBIC and
  fillcolor (Geometry.c's generic transform): the source point of output
  pixel (x, y) is a * (x + 0.5, y + 0.5) + c in float64; a point outside
  [0, size) takes the fill; else the filter reads from point - 0.5 with
  edge-clamped taps, in float64, truncating (bicubic clipped first). With
  NEAREST (data/clip_transforms.py's RandomRotation) Geometry.c's own
  paths: a matrix that only scales and translates samples as
  ImagingScaleAffine does, any other in affine_fixed's 16.16 fixed point
  (every image of this system fits it). `Rotate` builds Image.rotate's
  matrix about the centre, rounded to 15 places, and keeps its fast paths
  (0 and 180 degrees, and 90 and 270 on a square frame: transposes).
Randomness is the JAX module's: the same draws from the same
np.random.Generator in the same order (the op choice, then per op the 0.5
gate, the magnitude's normal, `_neg`'s draw and the interpolation index).
"""

from __future__ import annotations

import math
import re

import numpy as np

from tvts_torch.data.transforms import _nearest_index, scale_nearest

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)
NEAREST, BILINEAR, BICUBIC = 0, 2, 3  # Pillow's resampling filter ids
_HPARAMS_DEFAULT = {"translate_const": 250, "img_mean": _FILL}
_RANDOM_INTERPOLATION = (BILINEAR, BICUBIC)


# ---------------------------------------------------------------------------
# lookup tables
# ---------------------------------------------------------------------------
def _lut(frames: np.ndarray, lut) -> np.ndarray:
    """One table for every channel: Image.point with lut * 3."""
    return np.clip(np.asarray(lut), 0, 255).astype(np.uint8)[frames]


def _channel_luts(frames: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """luts [..., 3, 256] (a table a frame and channel, clipped to uint8)."""
    luts = np.clip(luts, 0, 255).astype(np.uint8).reshape(-1, 3, 256)
    f = frames.reshape(len(luts), -1, 3)
    out = luts[np.arange(len(luts))[:, None, None], np.arange(3), f]
    return out.reshape(frames.shape)


def _histograms(frames: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] uint8 -> [..., 3, 256] counts (Image.histogram a frame)."""
    lead = frames.shape[:-3]
    n = int(np.prod(lead, dtype=np.int64))
    f = frames.reshape(n, -1, 3).astype(np.int64)
    idx = (np.arange(n)[:, None, None] * 3 + np.arange(3)) * 256 + f
    return np.bincount(idx.ravel(), minlength=n * 3 * 256).reshape(*lead, 3, 256)


def _invert(frames, **__):
    return 255 - frames


def _posterize(frames, bits_to_keep, **__):
    if bits_to_keep >= 8:
        return frames
    mask = ~(2 ** (8 - bits_to_keep) - 1)
    return _lut(frames, [i & mask for i in range(256)])


def _solarize(frames, thresh, **__):
    return _lut(frames, [i if i < thresh else 255 - i for i in range(256)])


def _solarize_add(frames, add, thresh=128, **__):
    return _lut(frames, [min(255, i + add) if i < thresh else i for i in range(256)])


def _auto_contrast(frames, **__):
    """ImageOps.autocontrast (cutoff 0): each channel's [lo, hi] stretched to
    [0, 255] by int(ix * scale + offset); identity where hi <= lo."""
    h = _histograms(frames)
    nz = h > 0
    lo = np.argmax(nz, -1)
    hi = 255 - np.argmax(nz[..., ::-1], -1)
    ix = np.arange(256, dtype=np.float64)
    span = np.maximum(hi - lo, 1).astype(np.float64)
    scale = 255.0 / span
    offset = -lo * scale
    lut = np.trunc(ix * scale[..., None] + offset[..., None])
    lut = np.where((hi <= lo)[..., None], ix, lut)
    return _channel_luts(frames, lut.astype(np.int64))


def _equalize(frames, **__):
    """ImageOps.equalize: each channel's table (step // 2 + the counts below
    i) // step with step = (count - the last nonzero bin's) // 255; identity
    for one nonzero bin or step 0."""
    h = _histograms(frames)
    nz = h > 0
    hi = 255 - np.argmax(nz[..., ::-1], -1)
    last = np.take_along_axis(h, hi[..., None], -1)[..., 0]
    step = (h.sum(-1) - last) // 255
    below = np.cumsum(h, -1) - h
    safe = np.maximum(step, 1)[..., None]
    lut = (safe // 2 + below) // safe
    ident = (nz.sum(-1) <= 1) | (step == 0)
    lut = np.where(ident[..., None], np.arange(256), lut)
    return _channel_luts(frames, lut)


# ---------------------------------------------------------------------------
# ImageEnhance: Image.blend(degenerate, image, factor)
# ---------------------------------------------------------------------------
def _blend(degenerate: np.ndarray, image: np.ndarray, factor: float) -> np.ndarray:
    """Blend.c in C float: in1 + alpha * (in2 - in1), truncated; clipped to
    [0, 255] outside 0 <= alpha <= 1."""
    alpha = np.float32(factor)
    diff = (image.astype(np.int16) - degenerate.astype(np.int16)).astype(np.float32)
    out = degenerate.astype(np.float32) + alpha * diff
    if 0.0 <= alpha <= 1.0:
        return out.astype(np.uint8)
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


def _grey(frames: np.ndarray) -> np.ndarray:
    """RGB -> L (Convert.c rgb2l): (r 19595 + g 38470 + b 7471 + 0x8000) >> 16."""
    f = frames.astype(np.int32)
    return ((f[..., 0] * 19595 + f[..., 1] * 38470 + f[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def _color(frames, factor, **__):
    return _blend(np.repeat(_grey(frames)[..., None], 3, -1), frames, factor)


def _contrast(frames, factor, **__):
    """The degenerate frame is flat at int(mean of L + 0.5) (ImageStat's mean
    from the histogram, summed exactly)."""
    grey = _grey(frames)
    n = grey.shape[-2] * grey.shape[-1]
    sums = grey.reshape(*grey.shape[:-2], -1).sum(-1, dtype=np.int64)
    means = np.array([int(float(s) / n + 0.5) for s in np.ravel(sums)], np.uint8)
    degenerate = np.broadcast_to(means.reshape(sums.shape + (1, 1, 1)), frames.shape)
    return _blend(degenerate, frames, factor)


def _brightness(frames, factor, **__):
    return _blend(np.zeros_like(frames), frames, factor)


def _smooth(frames: np.ndarray) -> np.ndarray:
    """ImageFilter.SMOOTH (Filter.c's 3x3 on 8-bit bands): each inner pixel
    the weighted sum over 13, rounded to nearest. Pillow sums in float and
    rounds half up; the exact sum over 13 never lies within 1/26 of a half,
    far past float's error, so the integer (s + 6) // 13 is the same. The
    first and last rows and columns are copied."""
    H, W = frames.shape[-3:-1]
    if H < 3 or W < 3:
        return frames.copy()
    f = frames.astype(np.int32)
    s = 4 * f[..., 1:-1, 1:-1, :]
    for r in (slice(None, -2), slice(1, -1), slice(2, None)):
        s += f[..., r, :-2, :] + f[..., r, 1:-1, :] + f[..., r, 2:, :]
    out = frames.copy()
    out[..., 1:-1, 1:-1, :] = (s + 6) // 13
    return out


def _sharpness(frames, factor, **__):
    return _blend(_smooth(frames), frames, factor)


# ---------------------------------------------------------------------------
# Image.transform(AFFINE) with BILINEAR / BICUBIC and a fill colour
# ---------------------------------------------------------------------------
def _interp(taps: list, d, cubic: bool) -> np.ndarray:
    """Geometry.c's BILINEAR (a + (b - a) d) or BICUBIC (p1 + d (p2 + d (p3 +
    d p4))) along one axis, in float64 on the taps' values; the p's in the
    C expression's order (exact for integer taps). One tap where d is 0
    everywhere: both give that tap exactly."""
    if len(taps) == 1:
        return taps[0].astype(np.float64)
    if not cubic:
        a, b = taps
        return a + (b - a) * d
    v1, v2, v3, v4 = taps
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    t = d * p4
    t += p3
    t *= d
    t += p2
    t *= d
    return v2 + t


def _affine_nearest(frames: np.ndarray, a: tuple, fillcolor) -> np.ndarray:
    """Geometry.c's nearest-neighbour affine (module notes) on [..., H, W, 3]."""
    a0, a1, a2, a3, a4, a5 = a
    H, W = frames.shape[-3:-1]
    if a1 == 0 and a3 == 0:  # ImagingScaleAffine
        return scale_nearest(frames, _nearest_index(H, H, a5, a4),
                             _nearest_index(W, W, a2, a0), fillcolor)

    def fits(x, y):  # check_fixed
        return abs(x * a0 + y * a1 + a2) < 32768.0 and abs(x * a3 + y * a4 + a5) < 32768.0

    if not (fits(0, 0) and fits(W, H)):
        raise ValueError(f"a NEAREST affine past 16.16 fixed point ({W}x{H}) is not written")

    def fix(v):
        return math.floor(v * 65536.0 + 0.5)

    A0, A1, A3, A4 = fix(a0), fix(a1), fix(a3), fix(a4)
    A2, A5 = fix(a2 + a0 * 0.5 + a1 * 0.5), fix(a5 + a3 * 0.5 + a4 * 0.5)
    y = np.arange(H, dtype=np.int64)[:, None]
    x = np.arange(W, dtype=np.int64)[None, :]
    xin, yin = (A2 + y * A1 + x * A0) >> 16, (A5 + y * A4 + x * A3) >> 16
    inside = (xin >= 0) & (xin < W) & (yin >= 0) & (yin < H)
    out = frames[..., np.clip(yin, 0, H - 1), np.clip(xin, 0, W - 1), :]
    out[..., ~inside, :] = fillcolor
    return out


def _affine(frames: np.ndarray, matrix, resample: int, fillcolor=_FILL) -> np.ndarray:
    """Image.transform(size, AFFINE, matrix, resample, fillcolor=fillcolor) on
    [..., H, W, 3] uint8, the same matrix for every frame."""
    if resample == NEAREST:
        return _affine_nearest(frames, tuple(float(v) for v in matrix[:6]), fillcolor)
    if resample not in (BILINEAR, BICUBIC):
        raise ValueError(f"resample {resample}: NEAREST, BILINEAR or BICUBIC")
    a0, a1, a2, a3, a4, a5 = (float(v) for v in matrix[:6])
    H, W = frames.shape[-3:-1]
    xin = np.arange(W, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(H, dtype=np.float64)[:, None] + 0.5
    xx = a0 * xin + a1 * yin + a2  # [H, W]
    yy = a3 * xin + a4 * yin + a5
    inside = (xx >= 0.0) & (xx < W) & (yy >= 0.0) & (yy < H)
    xs, ys = xx - 0.5, yy - 0.5
    x, y = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
    dx, dy = (xs - x)[..., None], (ys - y)[..., None]
    # pixel-major [H * W, frames * 3]: a tap gathers one contiguous row a pixel
    lead = frames.shape[:-3]
    n = int(np.prod(lead, dtype=np.int64))
    src = frames.reshape(n, H * W, 3).transpose(1, 0, 2).reshape(H * W, n * 3)
    cubic = resample == BICUBIC
    offsets = (-1, 0, 1, 2) if cubic else (0, 1)
    rows = offsets if dy.any() else (0,)
    cols = offsets if dx.any() else (0,)
    cx = [np.clip(x + c, 0, W - 1) for c in cols]

    def tap(r, c):  # [H, W, n * 3] int16 at the edge-clamped (y + r, x + c)
        return src.take(np.clip(y + r, 0, H - 1) * W + c, axis=0).astype(np.int16)

    # the horizontal pass on the integer taps of each row, then the vertical one
    v = _interp([_interp([tap(r, c) for c in cx], dx, cubic) for r in rows], dy, cubic)
    out = np.where(inside[..., None], np.clip(np.trunc(v), 0, 255).astype(np.uint8),
                   np.tile(np.asarray(fillcolor, np.uint8), n))
    return out.reshape(H, W, n, 3).transpose(2, 0, 1, 3).reshape(frames.shape)


def _shear_x(frames, factor, **kw):
    return _affine(frames, (1, factor, 0, 0, 1, 0), **kw)


def _shear_y(frames, factor, **kw):
    return _affine(frames, (1, 0, 0, factor, 1, 0), **kw)


def _translate_x_abs(frames, pixels, **kw):
    return _affine(frames, (1, 0, pixels, 0, 1, 0), **kw)


def _translate_y_abs(frames, pixels, **kw):
    return _affine(frames, (1, 0, 0, 0, 1, pixels), **kw)


def _translate_x_rel(frames, pct, **kw):
    return _translate_x_abs(frames, pct * frames.shape[-2], **kw)


def _translate_y_rel(frames, pct, **kw):
    return _translate_y_abs(frames, pct * frames.shape[-3], **kw)


def _rotate(frames, degrees, **kw):
    """Image.rotate(degrees, resample, fillcolor): the inverse rotation about
    the centre as Image.rotate builds it (cos, sin rounded to 15 places)."""
    angle = degrees % 360.0
    h, w = frames.shape[-3:-1]
    if angle == 0:
        return frames.copy()
    if angle == 180:
        return frames[..., ::-1, ::-1, :].copy()
    if angle in (90, 270) and h == w:  # Image.transpose(ROTATE_90 / ROTATE_270)
        return np.rot90(frames, 1 if angle == 90 else 3, axes=(-3, -2)).copy()
    cx, cy = w / 2, h / 2
    angle = -math.radians(angle)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return _affine(frames, m, **kw)


# ---------------------------------------------------------------------------
# level -> op argument (reference :200-306), as the JAX module draws them
# ---------------------------------------------------------------------------
def _neg(rng, v):
    return -v if rng.random() > 0.5 else v


def _rotate_arg(level, hp, rng):
    return (_neg(rng, (level / _MAX_LEVEL) * 30.0),)


def _enhance_arg(level, hp, rng):
    return ((level / _MAX_LEVEL) * 1.8 + 0.1,)


def _enhance_increasing_arg(level, hp, rng):
    return (1.0 + _neg(rng, (level / _MAX_LEVEL) * 0.9),)


def _shear_arg(level, hp, rng):
    return (_neg(rng, (level / _MAX_LEVEL) * 0.3),)


def _translate_abs_arg(level, hp, rng):
    return (_neg(rng, (level / _MAX_LEVEL) * float(hp["translate_const"])),)


def _translate_rel_arg(level, hp, rng):
    return (_neg(rng, (level / _MAX_LEVEL) * hp.get("translate_pct", 0.45)),)


def _posterize_arg(level, hp, rng):
    return (int((level / _MAX_LEVEL) * 4),)


def _posterize_increasing_arg(level, hp, rng):
    return (4 - _posterize_arg(level, hp, rng)[0],)


def _posterize_original_arg(level, hp, rng):
    return (int((level / _MAX_LEVEL) * 4) + 4,)


def _solarize_arg(level, hp, rng):
    return (int((level / _MAX_LEVEL) * 256),)


def _solarize_increasing_arg(level, hp, rng):
    return (256 - _solarize_arg(level, hp, rng)[0],)


def _solarize_add_arg(level, hp, rng):
    return (int((level / _MAX_LEVEL) * 110),)


OPS = {
    # name: (fn, level_fn, geometric)
    "AutoContrast": (_auto_contrast, None, False),
    "Equalize": (_equalize, None, False),
    "Invert": (_invert, None, False),
    "Rotate": (_rotate, _rotate_arg, True),
    "Posterize": (_posterize, _posterize_arg, False),
    "PosterizeIncreasing": (_posterize, _posterize_increasing_arg, False),
    "PosterizeOriginal": (_posterize, _posterize_original_arg, False),
    "Solarize": (_solarize, _solarize_arg, False),
    "SolarizeIncreasing": (_solarize, _solarize_increasing_arg, False),
    "SolarizeAdd": (_solarize_add, _solarize_add_arg, False),
    "Color": (_color, _enhance_arg, False),
    "ColorIncreasing": (_color, _enhance_increasing_arg, False),
    "Contrast": (_contrast, _enhance_arg, False),
    "ContrastIncreasing": (_contrast, _enhance_increasing_arg, False),
    "Brightness": (_brightness, _enhance_arg, False),
    "BrightnessIncreasing": (_brightness, _enhance_increasing_arg, False),
    "Sharpness": (_sharpness, _enhance_arg, False),
    "SharpnessIncreasing": (_sharpness, _enhance_increasing_arg, False),
    "ShearX": (_shear_x, _shear_arg, True),
    "ShearY": (_shear_y, _shear_arg, True),
    "TranslateX": (_translate_x_abs, _translate_abs_arg, True),
    "TranslateY": (_translate_y_abs, _translate_abs_arg, True),
    "TranslateXRel": (_translate_x_rel, _translate_rel_arg, True),
    "TranslateYRel": (_translate_y_rel, _translate_rel_arg, True),
}

RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]

RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

_RAND_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2, "TranslateXRel": 0.1,
    "TranslateYRel": 0.1, "Color": 0.025, "Sharpness": 0.025,
    "AutoContrast": 0.025, "Solarize": 0.005, "SolarizeAdd": 0.005,
    "Contrast": 0.005, "Brightness": 0.005, "Equalize": 0.005,
    "Posterize": 0, "Invert": 0,
}


class AugmentOp:
    """One op with its 0.5 gate and jittered magnitude, the same arguments on
    every frame of a clip (reference :337-397)."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 hparams: dict | None = None):
        hp = dict(_HPARAMS_DEFAULT, **(hparams or {}))
        self.name = name
        self.fn, self.level_fn, self.geometric = OPS[name]
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = hp
        self.fill = hp.get("img_mean", _FILL)
        self.interpolation = hp.get("interpolation", _RANDOM_INTERPOLATION)
        self.magnitude_std = hp.get("magnitude_std", 0)

    def __call__(self, frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.prob < 1.0 and rng.random() > self.prob:
            return frames
        magnitude = self.magnitude
        if self.magnitude_std and self.magnitude_std > 0:
            magnitude = rng.normal(magnitude, self.magnitude_std)
        magnitude = min(_MAX_LEVEL, max(0.0, magnitude))
        args = self.level_fn(magnitude, self.hparams, rng) if self.level_fn is not None else ()
        kw = {}
        if self.geometric:
            resample = self.interpolation
            if isinstance(resample, (list, tuple)):
                resample = resample[int(rng.integers(len(resample)))]
            kw = {"fillcolor": self.fill, "resample": resample}
        return self.fn(frames, *args, **kw)


def rand_augment_ops(magnitude: float = 10, hparams: dict | None = None,
                     transforms: list[str] | None = None) -> list[AugmentOp]:
    transforms = transforms or RAND_TRANSFORMS
    return [AugmentOp(name, prob=0.5, magnitude=magnitude, hparams=hparams)
            for name in transforms]


def _select_rand_weights(weight_idx: int = 0, transforms=None) -> np.ndarray:
    transforms = transforms or RAND_TRANSFORMS
    if weight_idx != 0:
        raise ValueError("only weight set 0 exists (reference :444-450)")
    probs = np.array([_RAND_CHOICE_WEIGHTS_0[k] for k in transforms], float)
    return probs / probs.sum()


class RandAugment:
    """`num_ops` ops drawn from `ops` (or the legacy (num_ops, magnitude,
    mag_std) signature of cls_dataset, over RAND_TRANSFORMS) applied to a
    clip [T, H, W, 3] uint8."""

    def __init__(self, ops: list[AugmentOp] | None = None, num_ops: int = 2,
                 magnitude: float = 10, mag_std: float = 0.5,
                 choice_weights: np.ndarray | None = None,
                 rng: np.random.Generator | None = None):
        if ops is None:
            ops = rand_augment_ops(magnitude=magnitude, hparams={"magnitude_std": mag_std})
        self.ops = ops
        self.num_ops = num_ops
        self.choice_weights = choice_weights
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        idx = self.rng.choice(len(self.ops), size=self.num_ops,
                              replace=self.choice_weights is None, p=self.choice_weights)
        for i in idx:
            frames = self.ops[int(i)](frames, self.rng)
        return frames


def rand_augment_transform(config_str: str, hparams: dict | None = None,
                           rng: np.random.Generator | None = None) -> RandAugment:
    """'rand-m7-n4-mstd0.5-inc1' -> RandAugment (reference :481-531)."""
    hparams = dict(hparams or {})
    magnitude = _MAX_LEVEL
    num_layers = 2
    weight_idx = None
    transforms = RAND_TRANSFORMS
    config = config_str.split("-")
    if config[0] != "rand":
        raise ValueError(f"unknown augment scheme {config[0]!r}")
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            hparams.setdefault("magnitude_std", float(val))
        elif key == "inc":
            if bool(int(val)):
                transforms = RAND_INCREASING_TRANSFORMS
        elif key == "m":
            magnitude = int(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
        else:
            raise NotImplementedError(f"unknown RandAugment key {key!r}")
    ops = rand_augment_ops(magnitude=magnitude, hparams=hparams, transforms=transforms)
    weights = None if weight_idx is None else _select_rand_weights(weight_idx, transforms)
    return RandAugment(ops=ops, num_ops=num_layers, choice_weights=weights, rng=rng)
