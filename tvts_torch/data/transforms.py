"""Clip preprocessing (counterpart of tvts_tpu/data/transforms.py), with no PIL.

The host transforms are the reference's (v2/video_transforms/videoaug.py
`VideoTransform`, which base_dataset.py:44-45 sets for every video dataset;
pixelbert.py; feature_extraction_TVTSv2_B_16.py:63-76):
  video_transform:     NEAREST shorter-side resize to int(1.2 * crop), random
                       (train) or centre crop, /255, ImageNet mean / std;
  pixelbert_transform: BILINEAR shorter-side resize to int(1.15 * size), the
                       same crops, Inception mean / std;
  extract_transform:   BILINEAR resize to (size, size), /255, ImageNet.
The reference and the JAX package resize with Pillow. Here both resamplers
are Pillow's algorithms written in numpy, and they run on every machine:
- NEAREST (`resize_nearest`): Pillow's affine scaling
  (Geometry.c ImagingScaleAffine): source index int(x0 + (i + 0.5) * scale)
  with the position accumulated in float64 as Pillow adds it up;
- BILINEAR (`resize_bilinear`): Pillow's two-pass convolution (Resample.c),
  horizontal pass first, then vertical; the triangle filter's support scaled
  by the reduction, each output's weights normalised in float64, then
  rounded to 22-bit fixed point; each pass sums in integers from half a
  unit, shifts down and clips to uint8.
Both are bit for bit Pillow's (tests/test_torch_data.py holds them to Pillow
on random uint8 frames at the datasets' and extraction's sizes).

`preprocess_on_device` (the `--fast_pipeline` path of extraction) runs on
torch tensors on the caller's device: the JAX package's
`jax.image.resize(method="bilinear")` (a triangle kernel scaled by the
reduction when it shrinks, weights normalised per output, zero outside the
input), contracted over H then W in float32. Where it resizes, it lies
within 1e-4 of the JAX function after the normalisation: XLA rounds some
sample positions (float32, up to ~256) one unit apart from torch.
"""

from __future__ import annotations

import functools

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
INCEPTION_MEAN = np.array([0.5, 0.5, 0.5], dtype=np.float32)
INCEPTION_STD = np.array([0.5, 0.5, 0.5], dtype=np.float32)

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


# ---------------------------------------------------------------------------
# Pillow's resamplers in numpy
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel along one axis. Pillow accumulates
    the sample position (xo += a[0]) in float64 rather than multiplying, and
    truncates it."""
    step = float(in_size) / out_size
    pos = 0.0 + step * 0.5
    idx = np.empty(out_size, dtype=np.intp)
    for i in range(out_size):
        idx[i] = -1 if pos < 0.0 else int(pos)
        pos += step
    return idx


def resize_nearest(frames: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """[..., H, W, C] uint8 -> [..., h, w, C], size = (w, h) as Pillow takes it."""
    out_w, out_h = size
    in_h, in_w = frames.shape[-3:-1]
    if (out_w, out_h) == (in_w, in_h):
        return frames.copy()
    rows, cols = _nearest_index(in_h, out_h), _nearest_index(in_w, out_w)
    return frames[..., rows[:, None], cols[None, :], :]


@functools.lru_cache(maxsize=64)
def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(source index [k, out], fixed-point weight [k, out]) of Pillow's
    precompute_coeffs with the bilinear filter, then normalize_coeffs_8bpc.
    Taps past an output's own range carry weight 0 (and index 0)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((ksize, out_size), dtype=np.intp)
    weight = np.zeros((ksize, out_size), dtype=np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for v in w:  # in Pillow's order: the sum decides the rounding
            total += v
        for x, v in enumerate(w):
            if total != 0.0:
                v /= total
            fixed = v * (1 << _PRECISION_BITS)
            index[x, xx] = xmin + x
            weight[x, xx] = int(fixed - 0.5) if v < 0 else int(fixed + 0.5)
    return index, weight


def _bilinear_pass(frames: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One of Pillow's 8-bit passes, along the rows (axis -3) or the columns
    (axis -2) of [..., H, W, C]: the fixed-point sum over the taps from half a
    unit, shifted down and clipped to uint8."""
    index, weight = _bilinear_coeffs(frames.shape[axis], out_size)
    x = np.moveaxis(frames, axis, -1)  # [..., C, in]
    acc = np.full(x.shape[:-1] + (out_size,), 1 << (_PRECISION_BITS - 1), dtype=np.int64)
    for idx, w in zip(index, weight):
        acc += x[..., idx] * w
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bilinear(frames: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """[..., H, W, C] uint8 -> [..., h, w, C] by Pillow's BILINEAR, size = (w, h)."""
    out_w, out_h = size
    in_h, in_w = frames.shape[-3:-1]
    out = frames
    if out_w != in_w:
        out = _bilinear_pass(out, -2, out_w)
    if out_h != in_h:
        out = _bilinear_pass(out, -3, out_h)
    return out.copy() if out is frames else out


# ---------------------------------------------------------------------------
# host transforms
# ---------------------------------------------------------------------------
def _shorter_side_size(h: int, w: int, size: int) -> tuple[int, int] | None:
    """(w, h) of the shorter-side resize, or None where it is already `size`."""
    if (w <= h and w == size) or (h <= w and h == size):
        return None
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def _resize_shorter(frames: np.ndarray, size: int, resize) -> np.ndarray:
    target = _shorter_side_size(frames.shape[1], frames.shape[2], size)
    return frames if target is None else resize(frames, target)


def _normalise(frames: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    out = frames.astype(np.float32) / 255.0
    out = (out - mean) / std
    return out.transpose(0, 3, 1, 2)


def video_transform(
    frames: np.ndarray,
    crop_size: int = 224,
    mode: str = "test",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, 3, crop, crop] float32 normalised."""
    resized = _resize_shorter(frames, int(crop_size * 1.2), resize_nearest)
    h, w = resized.shape[1:3]
    if mode == "train":
        if rng is None:
            rng = np.random.default_rng()
        x1 = int(rng.integers(0, w - crop_size + 1))
        y1 = int(rng.integers(0, h - crop_size + 1))
    else:
        x1 = int(round((w - crop_size) / 2.0))
        y1 = int(round((h - crop_size) / 2.0))
    return _normalise(resized[:, y1: y1 + crop_size, x1: x1 + crop_size],
                      IMAGENET_MEAN, IMAGENET_STD)


def pixelbert_transform(frames: np.ndarray, size: int = 224,
                        mode: str = "test",
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """Pixel-BERT's clip transform (reference v2/video_transforms/pixelbert.py):
    shorter-side resize, random (train) or centre crop, Inception mean / std.
    [T, H, W, 3] uint8 -> [T, 3, size, size] float32."""
    resized = _resize_shorter(frames, int(size * 1.15), resize_bilinear)
    h, w = resized.shape[1:3]
    if mode == "train":
        if rng is None:
            rng = np.random.default_rng()
        y = int(rng.integers(0, h - size + 1))
        x = int(rng.integers(0, w - size + 1))
    else:
        y, x = (h - size) // 2, (w - size) // 2
    return _normalise(resized[:, y: y + size, x: x + size], INCEPTION_MEAN, INCEPTION_STD)


def extract_transform(frames: np.ndarray, size: int = 224) -> np.ndarray:
    """Feature-extraction preprocessing (reference
    feature_extraction_TVTSv2_B_16.py:63-76): bilinear resize to (size, size),
    /255, ImageNet normalisation. [T, H, W, 3] uint8 -> [T, 3, size, size]."""
    return _normalise(resize_bilinear(frames, (size, size)), IMAGENET_MEAN, IMAGENET_STD)


# ---------------------------------------------------------------------------
# on the device
# ---------------------------------------------------------------------------
def _resize_weights(in_size: int, out_size: int, device):
    """[in, out] float32 weights of jax.image.resize's linear method with
    antialiasing (jax._src.image.scale.compute_weight_mat, translation 0)."""
    import torch

    inv_scale = 1.0 / (out_size / in_size)  # in float64, then float32 where it is used
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def preprocess_on_device(frames_u8, crop_size: int = 224, crop_xy=None):
    """[B, T, H, W, 3] uint8 tensor -> [B, T, 3, crop, crop] float32 on its
    device. Where H == W == crop (the decoder resized the frames), no resize
    runs; otherwise the shorter side goes to int(1.2 * crop) by
    jax.image.resize's bilinear method, then the centre (or `crop_xy`) crop.

    As in the JAX package, this path resizes bilinearly where the host path
    takes NEAREST: hold accuracy evaluations to the host path."""
    import torch

    x = frames_u8.to(torch.float32)
    _, _, H, W, _ = x.shape
    if (H, W) != (crop_size, crop_size):
        short = min(H, W)
        target = int(crop_size * 1.2)
        nh, nw = (target, int(target * W / H)) if H < W else (int(target * H / W), target)
        if short != target:
            wh = _resize_weights(H, nh, x.device)
            ww = _resize_weights(W, nw, x.device)
            x = torch.einsum("bthwc,hy->btywc", x, wh)
            x = torch.einsum("btywc,wx->btyxc", x, ww)
        H, W = nh, nw
        if crop_xy is None:
            y1 = int(round((H - crop_size) / 2.0))
            x1 = int(round((W - crop_size) / 2.0))
        else:
            y1, x1 = crop_xy
        x = x[:, :, y1: y1 + crop_size, x1: x1 + crop_size, :]
    x = x / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    return x.permute(0, 1, 4, 2, 3)
