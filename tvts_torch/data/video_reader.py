"""Video decode layer (counterpart of tvts_tpu/data/video_reader.py): the
reference's decord / OpenCV frame decode with rand / uniform / fix_start
sampling (v2/base/base_dataset.py:288-328) and its multi-clip window reader
(base_dataset_yt.py:333-391).

Backends:
- "native": the port's FFmpeg decoder (`native_decoder`, ctypes), one
  sequential pass over sorted frame indices with swscale's RGB conversion
  and optional resize;
- "cv2": OpenCV, a seek a frame, as the reference's read_frames_cv2. cv2 is
  imported here only, when this backend first runs.
"auto" takes native where it builds, else cv2; with neither, it raises an
error naming both. TVTS_TPU_VIDEO_BACKEND sets the default, for this package
and the JAX one alike.

Every function returns uint8 [T, H, W, 3] RGB frames; the transforms
normalise.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from tvts_torch.data import native_decoder
from tvts_torch.ops.sampling import multi_clip_frame_indices, sample_frames

DEFAULT_BACKEND = os.environ.get("TVTS_TPU_VIDEO_BACKEND", "auto")


@functools.cache
def _cv2():
    """OpenCV with its own threading and OpenCL off (the reference's guard,
    v1/train_dist_TVTS.py:116-117), or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    cv2.setNumThreads(0)
    if hasattr(cv2, "ocl"):
        cv2.ocl.setUseOpenCL(False)
    return cv2


def _require_cv2():
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("the cv2 video backend needs OpenCV (cv2), which is not installed")
    return cv2


def pick_backend(backend: str = DEFAULT_BACKEND) -> str:
    """The backend `backend` resolves to: "native" or "cv2"."""
    if backend != "auto":
        return backend
    if native_decoder.available():
        return "native"
    if _cv2() is not None:
        return "cv2"
    raise RuntimeError("no video backend: the native decoder could not be built "
                       f"({native_decoder.unavailable_reason()}) and OpenCV (cv2) is not "
                       "installed")


def _open(path: str):
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    return cv2, cap


def get_video_len(path: str, backend: str = DEFAULT_BACKEND) -> int:
    if pick_backend(backend) == "native":
        return native_decoder.probe(path).n_frames
    cv2, cap = _open(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def probe(path: str, backend: str = DEFAULT_BACKEND):
    """(n_frames, duration_sec, width, height)."""
    if pick_backend(backend) == "native":
        info = native_decoder.probe(path)
        return info.n_frames, info.duration, info.width, info.height
    cv2, cap = _open(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    return n, (n / fps if fps > 0 else 0.0), w, h


def read_frames_at(path: str, frame_idxs, backend: str = DEFAULT_BACKEND,
                   resize: tuple[int, int] | None = None) -> np.ndarray:
    """Decode the given frame indices -> uint8 [T, H, W, 3] RGB."""
    if pick_backend(backend) == "native":
        return native_decoder.decode_frames(path, frame_idxs, resize=resize)
    cv2, cap = _open(path)
    frames, last = [], None
    try:
        for idx in frame_idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ret, frame = cap.read()
            if not ret:
                # the reference's read_frames_cv2 skips a frame that fails; the
                # JAX package and this one repeat the previous frame, so the clip
                # keeps its length (a documented deviation)
                if last is None:
                    raise IOError(f"frame {idx} decode failed: {path}")
                frame = last
            last = frame
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resize is not None:
                rgb = cv2.resize(rgb, resize, interpolation=cv2.INTER_LINEAR)
            frames.append(rgb)
    finally:
        cap.release()
    return np.stack(frames)


def read_frames_sampled(path: str, num_frames: int, sample: str = "rand",
                        fix_start: int | None = None,
                        rng: np.random.Generator | None = None,
                        backend: str = DEFAULT_BACKEND) -> tuple[np.ndarray, list[int]]:
    """The reference's read_frames_cv2 / decord: sample indices over the whole
    video, then decode. Returns (frames uint8 [T, H, W, 3], frame_idxs)."""
    vlen = get_video_len(path, backend)
    idxs = sample_frames(num_frames, vlen, sample=sample, fix_start=fix_start, rng=rng)
    return read_frames_at(path, idxs, backend), idxs


def read_multi_clip(path: str, begin_time_all, end_time_all, duration: float,
                    num_frames: int, num_clips: int,
                    rng: np.random.Generator | None = None,
                    backend: str = DEFAULT_BACKEND) -> np.ndarray:
    """The reference's video_clip_reader_cat: rand-sample num_frames *
    num_clips indices inside the [begin, end] window (fps estimated as
    vlen / duration)."""
    vlen = get_video_len(path, backend)
    idxs = multi_clip_frame_indices(begin_time_all, end_time_all, duration, vlen,
                                    num_frames, num_clips, rng=rng)
    return read_frames_at(path, idxs, backend)
