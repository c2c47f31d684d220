"""Temporal frame index sampling (counterpart of tvts_tpu/ops/sampling.py).

The reference's `sample_frames` (v2/base/base_dataset.py:270-285) splits the
video into `min(num_frames, vlen)` equal intervals and draws one index from
each:
- ``rand``: uniform over ``[lo, hi)``, ``hi`` the interval's end minus one
  (the reference never draws an interval's last frame);
- ``uniform``: the interval's midpoint ``(lo + hi) // 2``;
- ``fix_start``: ``lo + fix_start``, for the sliding-window test-time
  expansion.

Kept from the JAX package, a deliberate deviation from the reference: where an
interval is one frame wide, the reference's ``random.choice(range(lo, lo))``
raises; here it returns ``lo``. Only very short videos reach it, which the
reference absorbs by retrying another index.

The same indices as the JAX package from the same `np.random.Generator`.
"""

from __future__ import annotations

import numpy as np


def sample_frames(
    num_frames: int,
    vlen: int,
    sample: str = "rand",
    fix_start: int | None = None,
    rng: np.random.Generator | None = None,
) -> list[int]:
    """Pick `min(num_frames, vlen)` frame indices in [0, vlen)."""
    if vlen <= 0:
        raise ValueError(f"vlen must be positive, got {vlen}")
    acc_samples = min(num_frames, vlen)
    intervals = np.linspace(start=0, stop=vlen, num=acc_samples + 1).astype(int)
    los = intervals[:-1]
    his = intervals[1:] - 1  # exclusive upper bound of the draw, as in the reference

    if fix_start is not None:
        idxs = los + int(fix_start)
        return [int(i) for i in np.minimum(idxs, vlen - 1)]
    if sample == "rand":
        if rng is None:
            rng = np.random.default_rng()
        out = []
        for lo, hi in zip(los, his):
            hi = max(int(hi), int(lo) + 1)
            out.append(int(rng.integers(int(lo), hi)))
        return out
    if sample == "uniform":
        return [int((lo + hi) // 2) for lo, hi in zip(los, his)]
    raise NotImplementedError(f"unknown sampling mode: {sample!r}")


def multi_clip_frame_indices(
    begin_time_all,
    end_time_all,
    duration: float,
    vlen: int,
    num_frames: int,
    num_clips: int,
    rng: np.random.Generator | None = None,
) -> list[int]:
    """Frame indices spanning `num_clips` contiguous sub-clips of one video
    (the reference's `video_clip_reader_cat`, v2/base/base_dataset_yt.py:333-391):
    fps is estimated as vlen / duration, the window [begin_time_all[0],
    end_time_all[-1]] becomes a frame span, and `num_frames * num_clips`
    indices are rand-sampled inside it, offset by the window's start."""
    average_fps = vlen / float(duration)
    clip_len = (float(end_time_all[-1]) - float(begin_time_all[0])) * average_fps
    rel_index = max(int(float(begin_time_all[0]) * average_fps), 0)
    idxs = sample_frames(num_frames * num_clips, max(int(clip_len), 1), sample="rand", rng=rng)
    return [min(i + rel_index, vlen - 1) for i in idxs]
