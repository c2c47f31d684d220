"""Single-video feature extraction (counterpart of
tvts_tpu/eval/feature_extraction.py), the reference's
v2/downstream/feature_extraction_TVTSv2_B_16.py:54-94: 12 frames at
np.linspace(0, vlen - 1, 12), bilinear resize to 224², /255, ImageNet
normalisation, the full keep set arange(patches_per_frame) -> a [1, out]
video embedding.

`extract_video_feature` takes a video file (decoded by `video_reader`) or an
already transformed clip, [1, T, 3, H, W] float32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tvts_torch.data import video_reader
from tvts_torch.data.transforms import extract_transform, preprocess_on_device
from tvts_torch.eval.embed import make_embed_fns


def _frame_indices(video_path: str, num_frames: int, backend: str) -> list[int]:
    vlen = video_reader.get_video_len(video_path, backend=backend)
    # the reference's decord path: np.linspace(0, vlen - 1, num_frames) as ints
    return np.linspace(0, vlen - 1, num_frames).astype(int).tolist()


def load_clip_for_extraction(video_path: str, num_frames: int = 12,
                             size: int = 224, backend: str = "auto") -> np.ndarray:
    """[1, T, 3, size, size] float32: the host path (Pillow's bilinear resize)."""
    frames = video_reader.read_frames_at(
        video_path, _frame_indices(video_path, num_frames, backend), backend=backend)
    return extract_transform(frames, size=size)[None]


def load_clip_fast(video_path: str, num_frames: int = 12, size: int = 224,
                   backend: str = "auto", device: str | torch.device = "cpu") -> torch.Tensor:
    """The fast pipeline: the decoder resizes (swscale or cv2 bilinear), uint8
    frames go to `device`, and /255 and the normalisation run there
    (`preprocess_on_device`): a quarter of the host path's bytes to copy; the
    decoder's bilinear differs slightly from Pillow's, as in the JAX package."""
    frames = video_reader.read_frames_at(
        video_path, _frame_indices(video_path, num_frames, backend), backend=backend,
        resize=(size, size))
    return preprocess_on_device(torch.from_numpy(frames[None]).to(device), crop_size=size)


def extract_video_feature(model, video, backend: str = "auto", use_fused: bool = False,
                          fast_pipeline: bool = False) -> np.ndarray:
    """[1, out] float32 embedding of one clip through a TVTSv2's video tower
    with the full keep set. `video` is a path to a video file, or a clip
    already transformed as `load_clip_for_extraction` returns it."""
    cfg = model.cfg.vision
    device = next(model.parameters()).device
    if isinstance(video, (str, os.PathLike)):
        if fast_pipeline:
            clip = load_clip_fast(os.fspath(video), num_frames=cfg.num_frames,
                                  size=cfg.input_resolution, backend=backend, device=device)
        else:
            clip = load_clip_for_extraction(os.fspath(video), num_frames=cfg.num_frames,
                                            size=cfg.input_resolution, backend=backend)
    else:
        clip = video
    clip = torch.as_tensor(clip, dtype=torch.float32, device=device)
    keep = torch.arange(cfg.patches_per_frame, device=device)[None]
    _, embed_video = make_embed_fns(model, use_fused=use_fused)
    return embed_video(clip, keep).float().cpu().numpy()
