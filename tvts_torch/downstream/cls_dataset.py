"""Video classification dataset (counterpart of
tvts_tpu/downstream/cls_dataset.py; reference v1/downstream/ssv2.py /
kinetics.py and build_dataset): csv rows "path label" (space-separated, the
label last), three modes:

- train: `num_frames` indices, one drawn from each of as many equal
  segments; a short-side resize to short_side_size x a scale jitter in
  [1, 1.25), a random crop, an optional horizontal flip, RandAugment (4 ops
  at magnitude 7 on RAND_TRANSFORMS, as the JAX package builds it: not the
  recipe's `-inc1` set, ROADMAP.md §3), the ImageNet normalisation, random
  erasing (probability 0.25);
- validation: evenly spaced indices, a short-side resize, the centre crop;
- test: each video as test_num_segment temporal chunks x test_num_crop
  crops spread along the longer side; an item carries `sample_index` and
  `view_index`.
Each item draws from a np.random.Generator seeded with random.getrandbits(63),
so a seeded `random` gives the JAX package's items. Resizes are Pillow's
BILINEAR in numpy (data/transforms.resize_bilinear); decoding goes through
data/video_reader.py. numpy only.
"""

from __future__ import annotations

import os
import random

import numpy as np

from tvts_torch.data import video_reader
from tvts_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, _normalise, resize_bilinear
from tvts_torch.downstream.randaug import RandAugment
from tvts_torch.downstream.random_erasing import RandomErasing


def _resize_short(frames: np.ndarray, size: int) -> np.ndarray:
    h, w = frames.shape[1:3]
    if h <= w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nw, nh = size, max(size, int(round(h * size / w)))
    if (nh, nw) == (h, w):
        return frames
    return resize_bilinear(frames, (nw, nh))


class VideoClsDataset:
    def __init__(self,
                 anno_path: str,
                 data_path: str = "",
                 mode: str = "train",
                 num_frames: int = 16,
                 input_size: int = 224,
                 short_side_size: int = 224,
                 test_num_segment: int = 2,
                 test_num_crop: int = 3,
                 use_rand_augment: bool = True,
                 use_erasing: bool = True,
                 use_flip: bool = False,  # off for SSV2 (directional labels)
                 reader: str = "auto"):
        self.mode = mode
        self.data_path = data_path
        self.num_frames = num_frames
        self.input_size = input_size
        self.short_side_size = short_side_size
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        self.use_rand_augment = use_rand_augment
        self.use_erasing = use_erasing
        self.use_flip = use_flip
        self.reader = reader

        self.samples = []
        with open(anno_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                path, label = line.rsplit(" ", 1)
                self.samples.append((os.path.join(data_path, path), int(label)))

        if mode == "test":
            self.views = [(s, seg, crop) for s in range(len(self.samples))
                          for seg in range(test_num_segment)
                          for crop in range(test_num_crop)]

    def __len__(self):
        return len(self.views) if self.mode == "test" else len(self.samples)

    def _segment_indices(self, vlen: int, rng, seg: int | None = None) -> list[int]:
        n = self.num_frames
        if self.mode == "train":
            edges = np.linspace(0, vlen, n + 1).astype(int)
            return [int(rng.integers(lo, max(hi, lo + 1)))
                    for lo, hi in zip(edges[:-1], edges[1:])]
        if self.mode == "validation":
            edges = np.linspace(0, max(vlen - 1, 1), n).astype(int)
            return edges.tolist()
        # test: temporal segment `seg` of test_num_segment
        chunk = vlen / self.test_num_segment
        lo = chunk * seg
        edges = np.linspace(lo, min(lo + chunk, vlen) - 1, n).astype(int)
        return np.clip(edges, 0, vlen - 1).tolist()

    def _spatial_crop(self, frames: np.ndarray, rng, crop: int | None = None):
        size = self.input_size
        if self.mode == "train":
            scale = float(rng.uniform(1.0, 1.25))
            frames = _resize_short(frames, int(self.short_side_size * scale))
            h, w = frames.shape[1:3]
            y = int(rng.integers(0, h - size + 1))
            x = int(rng.integers(0, w - size + 1))
            return frames[:, y: y + size, x: x + size]
        frames = _resize_short(frames, self.short_side_size)
        h, w = frames.shape[1:3]
        if self.mode == "validation" or crop is None:
            y, x = (h - size) // 2, (w - size) // 2
        else:  # test: crops spread along the longer side
            if w >= h:
                xs = np.linspace(0, w - size, self.test_num_crop).astype(int)
                y, x = (h - size) // 2, int(xs[crop])
            else:
                ys = np.linspace(0, h - size, self.test_num_crop).astype(int)
                y, x = int(ys[crop]), (w - size) // 2
        return frames[:, y: y + size, x: x + size]

    def __getitem__(self, idx):
        rng = np.random.default_rng(random.getrandbits(63))
        seg = crop = None
        if self.mode == "test":
            sidx, seg, crop = self.views[idx]
        else:
            sidx = idx
        path, label = self.samples[sidx]

        vlen = max(video_reader.get_video_len(path, backend=self.reader), 1)
        idxs = self._segment_indices(vlen, rng, seg)
        frames = video_reader.read_frames_at(path, idxs, backend=self.reader)
        frames = self._spatial_crop(frames, rng, crop)

        if self.mode == "train":
            if self.use_flip and rng.random() < 0.5:
                frames = frames[:, :, ::-1].copy()
            if self.use_rand_augment:
                frames = RandAugment(num_ops=4, magnitude=7, rng=rng)(frames)
        clip = _normalise(frames, IMAGENET_MEAN, IMAGENET_STD)  # [T, C, H, W]
        if self.mode == "train" and self.use_erasing:
            clip = RandomErasing(probability=0.25, rng=rng)(clip)

        out = {"video": clip.astype(np.float32), "label": label}
        if self.mode == "test":
            out["sample_index"] = sidx
            out["view_index"] = seg * self.test_num_crop + crop
        return out
