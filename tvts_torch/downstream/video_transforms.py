"""The v1 downstream video-transform library (counterpart of
tvts_tpu/downstream/video_transforms.py; reference
v1/downstream/video_transforms.py), in numpy with no PIL.

The functional API flows float32 numpy arrays shaped [T, C, H, W] (the
reference's tensor layout), values in [0, 1] unless noted. Where the JAX
module takes a PIL image or a list of PIL frames, this one takes a uint8
[H, W, C] frame, a [T, H, W, C] clip or a list of frames, and returns
arrays. Its resizes are Pillow's in numpy (data/transforms.resize: NEAREST,
BILINEAR, BICUBIC and LANCZOS, with Image.resize's box), its RandAugment
downstream/randaug.py's and its ColorJitter data/clip_transforms.py's, so
every output is bit for bit the JAX module's (tests/test_torch_frozen.py).
RNG is injectable (np.random.Generator); the draws are the JAX module's, in
its order.
"""

from __future__ import annotations

import math

import numpy as np

from tvts_torch.data.clip_transforms import (  # noqa: F401  (re-exported surface)
    CenterCrop,
    ColorJitter,
    Compose,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    RandomResize,
    RandomRotation,
    Resize,
)
from tvts_torch.data.transforms import BICUBIC, BILINEAR, LANCZOS, NEAREST, resize

_RESAMPLE = {"bilinear": BILINEAR, "bicubic": BICUBIC, "nearest": NEAREST, "lanczos": LANCZOS}


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def _interp_resize(images: np.ndarray, size_h: int, size_w: int,
                   mode: str = "bilinear") -> np.ndarray:
    """Per-frame Pillow resize of [T, C, H, W] float images through uint8
    (the reference uses torch.nn.functional.interpolate)."""
    frames = np.clip(images.transpose(0, 2, 3, 1) * 255.0, 0, 255).astype(np.uint8)
    out = resize(frames, (size_w, size_h), _RESAMPLE[mode]).astype(np.float32) / 255.0
    return out.transpose(0, 3, 1, 2)


def random_short_side_scale_jitter(images, min_size, max_size, boxes=None,
                                   inverse_uniform_sampling=False, rng=None):
    """Scale the short side to a size sampled in [min_size, max_size]
    (reference :44-100)."""
    rng = _rng(rng)
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    T, C, height, width = images.shape
    if (width <= height and width == size) or (height <= width and height == size):
        return images, boxes
    if width < height:
        new_w, new_h = size, int(math.floor(height / width * size))
    else:
        new_w, new_h = int(math.floor(width / height * size)), size
    out = _interp_resize(images, new_h, new_w)
    if boxes is not None:
        boxes = boxes * (new_w / width if width < height else new_h / height)
    return out, boxes


def crop_boxes(boxes, x_offset, y_offset):
    """Shift box coordinates by the crop offset (reference :101-119)."""
    cropped = boxes.copy()
    cropped[:, [0, 2]] = boxes[:, [0, 2]] - x_offset
    cropped[:, [1, 3]] = boxes[:, [1, 3]] - y_offset
    return cropped


def random_crop(images, size, boxes=None, rng=None):
    """Random spatial crop of [T, C, H, W] (reference :120-155)."""
    rng = _rng(rng)
    T, C, height, width = images.shape
    if height == size and width == size:
        return images, boxes
    y_offset = int(rng.integers(0, height - size + 1))
    x_offset = int(rng.integers(0, width - size + 1))
    cropped = images[:, :, y_offset:y_offset + size, x_offset:x_offset + size]
    if boxes is not None:
        boxes = crop_boxes(boxes, x_offset, y_offset)
    return cropped, boxes


def horizontal_flip(prob, images, boxes=None, rng=None):
    """Flip with probability `prob` (reference :156-190)."""
    rng = _rng(rng)
    if rng.uniform() < prob:
        width = images.shape[3]
        images = images[..., ::-1].copy()
        if boxes is not None:
            boxes = boxes.copy()
            boxes[:, [0, 2]] = width - boxes[:, [2, 0]] - 1
    return images, boxes


def uniform_crop(images, size, spatial_idx, boxes=None, scale_size=None):
    """Deterministic left/center/right (or top/center/bottom) crop
    (reference :191-253). spatial_idx in {0, 1, 2}."""
    assert spatial_idx in (0, 1, 2)
    T, C, height, width = images.shape
    if scale_size is not None:
        if width <= height:
            height = int(round(height / width * scale_size))
            width = scale_size
        else:
            width = int(round(width / height * scale_size))
            height = scale_size
        images = _interp_resize(images, height, width)
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        y_offset = 0 if spatial_idx == 0 else (height - size if spatial_idx == 2 else y_offset)
    else:
        x_offset = 0 if spatial_idx == 0 else (width - size if spatial_idx == 2 else x_offset)
    cropped = images[:, :, y_offset:y_offset + size, x_offset:x_offset + size]
    if boxes is not None:
        boxes = crop_boxes(boxes, x_offset, y_offset)
    return cropped, boxes


def clip_boxes_to_image(boxes, height, width):
    """Clamp boxes into the image (reference :254-275)."""
    clipped = boxes.copy()
    clipped[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0.0, width - 1)
    clipped[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0.0, height - 1)
    return clipped


def blend(images1, images2, alpha):
    """alpha * a + (1 - alpha) * b (reference :276-291)."""
    return images1 * alpha + images2 * (1 - alpha)


def grayscale(images):
    """ITU-R 601 luma over BGR channels, broadcast back (reference :292-313)."""
    gray = 0.299 * images[:, 2] + 0.587 * images[:, 1] + 0.114 * images[:, 0]
    out = np.empty_like(images)
    out[:] = gray[:, None]
    return out


def brightness_jitter(var, images, rng=None):
    alpha = 1.0 + _rng(rng).uniform(-var, var)
    return blend(images, np.zeros_like(images), alpha)


def contrast_jitter(var, images, rng=None):
    alpha = 1.0 + _rng(rng).uniform(-var, var)
    gray = grayscale(images)
    gray[:] = gray.mean(axis=(1, 2, 3), keepdims=True)
    return blend(images, gray, alpha)


def saturation_jitter(var, images, rng=None):
    alpha = 1.0 + _rng(rng).uniform(-var, var)
    return blend(images, grayscale(images), alpha)


def color_jitter(images, img_brightness=0, img_contrast=0, img_saturation=0, rng=None):
    """Apply the enabled jitters in random order (reference :314-348)."""
    rng = _rng(rng)
    jitters = []
    if img_brightness != 0:
        jitters.append(("brightness", img_brightness))
    if img_contrast != 0:
        jitters.append(("contrast", img_contrast))
    if img_saturation != 0:
        jitters.append(("saturation", img_saturation))
    if jitters:
        order = rng.permutation(len(jitters))
        fns = {"brightness": brightness_jitter, "contrast": contrast_jitter,
               "saturation": saturation_jitter}
        for idx in order:
            name, var = jitters[idx]
            images = fns[name](var, images, rng=rng)
    return images


def lighting_jitter(images, alphastd, eigval, eigvec, rng=None):
    """AlexNet-style PCA lighting noise (reference :407-454)."""
    if alphastd == 0:
        return images
    rng = _rng(rng)
    alpha = rng.normal(0, alphastd, size=3)
    eigval = np.asarray(eigval, dtype=np.float32)
    eigvec = np.asarray(eigvec, dtype=np.float32)
    rgb = (eigvec * alpha[None] * eigval[None]).sum(axis=1)
    out = images.copy()
    for c in range(images.shape[1]):
        out[:, c] = images[:, c] + rgb[2 - c]
    return out


def color_normalization(images, mean, stddev):
    """Per-channel normalize (reference :455-498)."""
    mean = np.asarray(mean, dtype=np.float32)
    stddev = np.asarray(stddev, dtype=np.float32)
    return (images - mean[None, :, None, None]) / stddev[None, :, None, None]


def _get_param_spatial_crop(scale, ratio, height, width, rng, num_repeat=10, log_scale=True,
                            switch_hw=False):
    """Sample an (i, j, h, w) crop window (reference :499-540)."""
    for _ in range(num_repeat):
        area = height * width
        target_area = area * rng.uniform(scale[0], scale[1])
        if log_scale:
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect_ratio = math.exp(rng.uniform(*log_ratio))
        else:
            aspect_ratio = rng.uniform(*ratio)
        if switch_hw and rng.uniform() < 0.5:
            aspect_ratio = 1.0 / aspect_ratio
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    # fallback: center crop at clamped aspect
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


def random_resized_crop(images, target_height, target_width, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0), rng=None):
    """One crop window for the whole clip (reference :541-575)."""
    rng = _rng(rng)
    T, C, height, width = images.shape
    i, j, h, w = _get_param_spatial_crop(scale, ratio, height, width, rng)
    cropped = images[:, :, i:i + h, j:j + w]
    return _interp_resize(cropped, target_height, target_width)


def random_resized_crop_with_shift(images, target_height, target_width, scale=(0.08, 1.0),
                                   ratio=(3.0 / 4.0, 4.0 / 3.0), rng=None):
    """Crop window interpolated from the first to the last frame
    (reference :576-620)."""
    rng = _rng(rng)
    T, C, height, width = images.shape
    i, j, h, w = _get_param_spatial_crop(scale, ratio, height, width, rng)
    i_, j_, h_, w_ = _get_param_spatial_crop(scale, ratio, height, width, rng)
    i_s = np.linspace(i, i_, num=T).astype(int)
    j_s = np.linspace(j, j_, num=T).astype(int)
    h_s = np.linspace(h, h_, num=T).astype(int)
    w_s = np.linspace(w, w_, num=T).astype(int)
    out = np.empty((T, C, target_height, target_width), dtype=np.float32)
    for t in range(T):
        window = images[t:t + 1, :, i_s[t]:i_s[t] + h_s[t], j_s[t]:j_s[t] + w_s[t]]
        out[t] = _interp_resize(window, target_height, target_width)[0]
    return out


def create_random_augment(input_size, auto_augment=None, interpolation="bilinear", rng=None):
    """Clip RandAugment factory (reference :621-656 delegates to the timm
    lineage; here to downstream/randaug.py): a callable on uint8 [T, H, W, C]
    clips, the identity without a "rand-..." config."""
    from tvts_torch.downstream.randaug import rand_augment_transform

    if auto_augment and auto_augment.startswith("rand"):
        interp = _RESAMPLE.get(interpolation, interpolation)
        return rand_augment_transform(auto_augment, {"interpolation": interp}, rng=rng)

    def identity(frames):
        return frames

    return identity


def random_sized_crop_img(im, size, jitter_scale=(0.08, 1.0),
                          jitter_aspect=(3.0 / 4.0, 4.0 / 3.0), max_iter=10, rng=None):
    """Single-image random resized crop, shared window logic
    (reference :657-691)."""
    rng = _rng(rng)
    assert im.ndim == 3  # [C, H, W]
    height, width = im.shape[1], im.shape[2]
    i, j, h, w = _get_param_spatial_crop(jitter_scale, jitter_aspect, height, width, rng,
                                         num_repeat=max_iter, log_scale=False, switch_hw=True)
    cropped = im[None, :, i:i + h, j:j + w]
    return _interp_resize(cropped, size, size)[0]


_RANDOM_INTERPOLATION = ("bilinear", "bicubic")


def _as_clip(clip) -> tuple[np.ndarray, bool]:
    """(uint8 [T, H, W, C], was it a single [H, W, C] frame) of a frame, a
    clip or a list of frames."""
    if isinstance(clip, np.ndarray):
        return (clip[None], True) if clip.ndim == 3 else (clip, False)
    return np.stack([np.asarray(f) for f in clip]), False


class RandomResizedCropAndInterpolation:
    """Random-window crop + resize with (optionally random) interpolation
    (reference :692-797, the timm/Inception-style train crop). One window and
    one interpolation are sampled per call, so a clip stays spatially
    consistent; a single frame in gives a frame out."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation="bilinear", rng=None):
        self.size = size if isinstance(size, tuple) else (size, size)
        if scale[0] > scale[1] or ratio[0] > ratio[1]:
            raise ValueError("range should be of kind (min, max)")
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.interpolation = interpolation
        self.rng = rng

    def get_params(self, width, height, rng):
        """Sample the (i, j, h, w) window (reference :726-766)."""
        return _get_param_spatial_crop(self.scale, self.ratio, height, width, rng,
                                       num_repeat=10, log_scale=True)

    def __call__(self, clip):
        rng = _rng(self.rng)
        frames, single = _as_clip(clip)
        h, w = frames.shape[1:3]
        i, j, ch, cw = self.get_params(w, h, rng)
        interp = self.interpolation
        if interp == "random":
            interp = _RANDOM_INTERPOLATION[int(rng.integers(0, len(_RANDOM_INTERPOLATION)))]
        out = resize(frames, (self.size[1], self.size[0]), _RESAMPLE[interp],
                     box=(j, i, j + cw, i + ch))
        return out[0] if single else out

    def __repr__(self):
        return (f"{type(self).__name__}(size={self.size}, scale="
                f"{tuple(round(s, 4) for s in self.scale)}, ratio="
                f"{tuple(round(r, 4) for r in self.ratio)}, "
                f"interpolation={self.interpolation})")


def transforms_imagenet_train(img_size=224, scale=None, ratio=None, hflip=0.5, vflip=0.0,
                              color_jitter=0.4, auto_augment=None, interpolation="random",
                              mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                              re_prob=0.0, re_mode="const", re_count=1, separate=False,
                              rng=None):
    """The timm-style ImageNet train pipeline (reference :799-901).

    Returns a callable mapping a uint8 [H, W, C] frame, [T, H, W, C] clip or
    list of frames to a normalized float32 [C, H, W] (a frame) or
    [T, C, H, W] (a clip) array: primary (random resized crop + flips),
    secondary (RandAugment when ``auto_augment`` is set, else ColorJitter),
    final (to-tensor + normalize + optional RandomErasing). With
    ``separate=True`` the three stages are returned as a tuple, as the
    reference does for mixing datasets. All randomness is clip-consistent
    and flows through the injectable ``rng``.
    """
    from tvts_torch.data.clip_transforms import ClipToTensor
    from tvts_torch.downstream.randaug import rand_augment_transform
    from tvts_torch.downstream.random_erasing import RandomErasing

    img_size = img_size[-2:] if isinstance(img_size, tuple) else (img_size, img_size)
    scale = tuple(scale or (0.08, 1.0))
    ratio = tuple(ratio or (3.0 / 4.0, 4.0 / 3.0))
    the_rng = _rng(rng)

    rrc = RandomResizedCropAndInterpolation(img_size, scale=scale, ratio=ratio,
                                            interpolation=interpolation, rng=the_rng)

    def primary(clip):
        frames, single = _as_clip(rrc(clip))
        if hflip > 0.0 and the_rng.uniform() < hflip:
            frames = frames[:, :, ::-1]
        if vflip > 0.0 and the_rng.uniform() < vflip:
            frames = frames[:, ::-1]
        frames = np.ascontiguousarray(frames)
        return frames[0] if single else frames

    if auto_augment:
        if not auto_augment.startswith("rand"):
            raise NotImplementedError(f"auto_augment scheme {auto_augment!r} not supported "
                                      "(reference :858-862 likewise implements rand-* only)")
        aa_params = {"translate_const": int(min(img_size) * 0.45),
                     "img_mean": tuple(min(255, round(255 * x)) for x in mean)}
        if interpolation and interpolation != "random":
            aa_params["interpolation"] = interpolation
        ra = rand_augment_transform(auto_augment, aa_params, rng=the_rng)

        def secondary(clip):
            frames, single = _as_clip(clip)
            out = ra(frames)
            return out[0] if single else out
    elif color_jitter is not None:
        amounts = (tuple(color_jitter) if isinstance(color_jitter, (list, tuple))
                   else (float(color_jitter),) * 3)
        cj = ColorJitter(*amounts, rng=the_rng)

        def secondary(clip):
            frames, single = _as_clip(clip)
            out = cj(frames)
            return out[0] if single else out
    else:
        def secondary(clip):
            return clip

    to_tensor = ClipToTensor()
    mean_arr = np.asarray(mean, dtype=np.float32)
    std_arr = np.asarray(std, dtype=np.float32)
    eraser = (RandomErasing(re_prob, mode=re_mode, max_count=re_count, cube=False, rng=the_rng)
              if re_prob > 0.0 else None)

    def final(clip):
        frames, single = _as_clip(clip)
        x = to_tensor(frames)
        x = (x - mean_arr[None, :, None, None]) / std_arr[None, :, None, None]
        if eraser is not None:
            x = eraser(x)
        return x[0] if single else x

    if separate:
        return primary, secondary, final

    def pipeline(clip):
        return final(secondary(primary(clip)))

    return pipeline


class ThreeCrop:
    """Three uniform crops along the long side (reference :1038-1084)."""

    def __init__(self, size):
        self.size = size if isinstance(size, tuple) else (size, size)

    def __call__(self, clip):
        """clip: a list of uint8 [H, W, C] frames or a float [T, C, H, W]
        array -> [3T, C, h, w] (left/center/right crops concatenated along the
        frame dim)."""
        if isinstance(clip, (list, tuple)):
            arr = np.stack([np.asarray(f, dtype=np.float32).transpose(2, 0, 1) / 255.0
                            for f in clip])
        else:
            arr = np.asarray(clip, dtype=np.float32)
        h, w = arr.shape[2], arr.shape[3]
        size = self.size[0]
        if size != min(h, w):
            scale = size / min(h, w)
            arr = _interp_resize(arr, int(round(h * scale)), int(round(w * scale)))
        crops = [uniform_crop(arr, size, idx)[0] for idx in (0, 1, 2)]
        return np.concatenate(crops, axis=0)
