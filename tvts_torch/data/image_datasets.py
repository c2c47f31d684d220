"""Image-text datasets, TVTS v1's CC3M path (counterpart of
tvts_tpu/data/image_datasets.py), with no PIL and no pandas.

The reference's `TextImageDataset` (v2/base/base_dataset.py:146-194) and
v1/data_loader/ConceptualCaptions_dataset.py: tsv metadata of (caption,
relative path); an image is decoded, transformed (train: a random resized
crop, scale 0.5-1 and aspect 3/4-4/3, then a flip; otherwise: the shorter
side to 256, a centre crop of 256, then the size) and tiled into a video of
`num_frames` frames so it flows through the video tower.

The JAX package decodes and resamples with Pillow; here:
- `decode_image` decodes with OpenCV (imported inside it), unchanged: no
  EXIF rotation, as Pillow's open; BGR -> RGB; grey -> RGB by copying the
  channel (Pillow resamples the L image and converts it after, the same
  numbers); BGRA -> RGBA with its alpha kept for the resamples. 8-bit
  images only;
- crops are numpy slices, zero outside the image as Pillow's crop;
- BILINEAR resizes are data/transforms.py's Pillow-exact resampler; an RGBA
  image is resized premultiplied by its alpha and unpremultiplied after, as
  Pillow resizes RGBA (RGBa), and a resize to its own size is a copy;
- then the alpha is dropped (Pillow's convert("RGB")), /255, ImageNet mean
  and std.
On PNG every item is bit for bit the JAX package's (tests/test_torch_v1.py);
on JPEG, OpenCV's and Pillow's libjpeg builds may decode a pixel differently
(the test records the size of that difference). Palette images, which
Pillow resamples with NEAREST, are not handled alike.
Items seed their generator from Python's `random.getrandbits(63)`, as the
JAX package's do. Like the JAX classes, these accept and ignore keys they do
not use (`per_tube_masks`: an item's keep set is one [n_keep] set).
"""

from __future__ import annotations

import os
import random
import threading

import numpy as np

from tvts_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, resize_bilinear


def decode_image(source: str | bytes) -> np.ndarray:
    """A file path or encoded bytes -> [H, W, 3] RGB or [H, W, 4] RGBA uint8."""
    import cv2

    if isinstance(source, (bytes, bytearray)):
        img = cv2.imdecode(np.frombuffer(source, np.uint8), cv2.IMREAD_UNCHANGED)
    else:
        img = cv2.imread(source, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cannot decode image {source if isinstance(source, str) else ''}")
    if img.dtype != np.uint8:
        raise ValueError(f"{img.dtype} image: 8-bit images only")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa: each colour times alpha / 255 (MULDIV255)."""
    a = img[..., 3:].astype(np.uint32)
    tmp = img[..., :3].astype(np.uint32) * a + 128
    return np.concatenate([(((tmp >> 8) + tmp) >> 8).astype(np.uint8), img[..., 3:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: each colour times 255 / alpha, clipped; kept
    where alpha is 0 or 255."""
    a = img[..., 3:].astype(np.uint32)
    c = img[..., :3].astype(np.uint32)
    scaled = np.minimum(255 * c // np.maximum(a, 1), 255)
    rgb = np.where((a == 0) | (a == 255), c, scaled).astype(np.uint8)
    return np.concatenate([rgb, img[..., 3:]], axis=-1)


def _resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Pillow's BILINEAR resize of [H, W, C] to size = (w, h)."""
    if size == (img.shape[1], img.shape[0]):
        return img.copy()
    if img.shape[2] == 4:
        return _unpremultiply(resize_bilinear(_premultiply(img), size))
    return resize_bilinear(img, size)


def _crop(img: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """Pillow's crop((x, y, x + w, y + h)): zeros where the box leaves the image."""
    out = np.zeros((h, w, img.shape[2]), dtype=img.dtype)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, img.shape[1]), min(y + h, img.shape[0])
    if x1 > x0 and y1 > y0:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = img[y0:y1, x0:x1]
    return out


def image_transform(img: np.ndarray, size: int, mode: str,
                    rng: np.random.Generator) -> np.ndarray:
    """[H, W, 3 or 4] uint8 (decode_image) -> [3, size, size] float32."""
    h, w = img.shape[:2]
    if mode == "train":
        # RandomResizedCrop(scale 0.5-1.0) + horizontal flip
        area = w * h
        for _ in range(10):
            target = rng.uniform(0.5, 1.0) * area
            aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * aspect)))
            ch = int(round(np.sqrt(target / aspect)))
            if cw <= w and ch <= h:
                x = int(rng.integers(0, w - cw + 1))
                y = int(rng.integers(0, h - ch + 1))
                img = _crop(img, x, y, cw, ch)
                break
        img = _resize(img, (size, size))
        if rng.random() < 0.5:
            img = img[:, ::-1]
    else:
        scale = 256 / min(w, h)
        img = _resize(img, (int(w * scale), int(h * scale)))
        h, w = img.shape[:2]
        img = _resize(_crop(img, (w - 256) // 2, (h - 256) // 2, 256, 256), (size, size))
    arr = img[..., :3].astype(np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)


class TextImageDataset:
    """Metadata-driven image + caption dataset, an item a video of
    `num_frames` copies of the image."""

    def __init__(self, dataset_name, text_params, video_params, data_dir,
                 metadata_dir=None, split="train", cut=None, subsample=1,
                 sliding_window_stride=-1, reader="auto",
                 patches_per_frame=196, mask_ratio=0.0, meta_root="meta_data",
                 **_):
        self.dataset_name = dataset_name
        self.video_params = video_params
        self.data_dir = os.path.expandvars(data_dir)
        self.split = split
        self.patches_per_frame = patches_per_frame
        self.mask_ratio = mask_ratio
        self.meta_root = meta_root
        self._load_metadata()

    def _load_metadata(self):
        raise NotImplementedError

    def _get_image_path(self, sample):
        raise NotImplementedError

    def _get_caption(self, sample):
        return sample.values[0]

    def _read_table(self, name: str) -> list:
        # datasets.py registers these classes, so its table reader is imported here
        from tvts_torch.data.datasets import read_table

        return read_table(os.path.join(self.meta_root, name))[1]

    def __len__(self):
        return len(self.metadata)

    def _image(self, load, rng) -> np.ndarray:
        """[3, res, res]: load() transformed; a black image where lax loading fails."""
        res = self.video_params["input_res"]
        try:
            return image_transform(load(), res, self.split, rng)
        except Exception:
            if self.video_params.get("loading", "strict") == "strict":
                raise
            return np.zeros((3, res, res), dtype=np.float32)

    def _keep(self, rng) -> np.ndarray:
        n_keep = int(self.patches_per_frame * (1 - self.mask_ratio))
        return rng.permutation(self.patches_per_frame)[:n_keep].astype(np.int32)

    def __getitem__(self, item):
        rng = np.random.default_rng(random.getrandbits(63))
        sample = self.metadata[item % len(self.metadata)]
        path, rel = self._get_image_path(sample)
        arr = self._image(lambda: decode_image(path), rng)
        keep = self._keep(rng)
        caption = self._get_caption(sample)
        # a static video of num_frames (the v1 tubelet-2 patchify needs >= 2)
        nf = int(self.video_params.get("num_frames", 1))
        video = np.repeat(arr[None], max(nf, 1), axis=0).astype(np.float32)
        return {"video": video, "text": caption, "keep_ind": keep,
                "meta": {"raw_captions": caption, "paths": rel, "dataset": self.dataset_name}}


class TextImageTarDataset(TextImageDataset):
    """Images in tar shards (reference base_dataset.py:198-221); tsv rows of
    (caption, shard path, member). Each thread keeps its own tar handles
    (a tarfile object is not thread-safe). An item is one frame."""

    def __init__(self, *args, **kwargs):
        self._tls = threading.local()
        super().__init__(*args, **kwargs)

    def _tar_handle(self, tar_path: str):
        import tarfile

        cache = getattr(self._tls, "tars", None)
        if cache is None:
            cache = self._tls.tars = {}
        if tar_path not in cache:
            cache[tar_path] = tarfile.open(tar_path, "r")
        return cache[tar_path]

    def _load_image(self, tar_rel: str, member: str) -> np.ndarray:
        tar = self._tar_handle(os.path.join(self.data_dir, tar_rel))
        return decode_image(tar.extractfile(member).read())

    def _load_metadata(self):
        self.metadata = self._read_table(f"{self.dataset_name.lower()}_{self.split}.tsv")

    def __getitem__(self, item):
        rng = np.random.default_rng(random.getrandbits(63))
        sample = self.metadata[item % len(self.metadata)]
        arr = self._image(lambda: self._load_image(sample.values[1], sample.values[2]), rng)
        keep = self._keep(rng)
        caption = self._get_caption(sample)
        return {"video": arr[None].astype(np.float32), "text": caption, "keep_ind": keep,
                "meta": {"raw_captions": caption, "paths": str(sample.values[2]),
                         "dataset": self.dataset_name}}


class ConceptualCaptions3M(TextImageDataset):
    """CC3M (reference v1/data_loader/ConceptualCaptions_dataset.py:49-80):
    tsv rows of (caption, file name) under training/ or validation/; the val
    split is 1000 rows drawn as pandas' sample(n, random_state=0) draws
    them; the caption is list-wrapped, as YT-Temporal's transcripts."""

    SPLIT_FILES = {"train": "cc3m_train.tsv", "val": "cc3m_val.tsv", "test": "cc3m_val.tsv"}

    def _load_metadata(self):
        from tvts_torch.data.datasets import sample_rows

        rows = self._read_table(self.SPLIT_FILES[self.split])
        if self.split == "val":
            rows = sample_rows(rows, n=min(1000, len(rows)), random_state=0)
        self.metadata = rows

    def _get_image_path(self, sample):
        rel = os.path.join("training" if self.split == "train" else "validation",
                           str(sample.values[1]))
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, sample):
        return [sample.values[0]]
