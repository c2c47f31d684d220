"""Single-video feature extraction (counterpart of
tvts_tpu/eval/feature_extraction.py) on a decoded, normalised clip.

Decoding a video file waits for a JAX-free reader: the clip comes in as the
JAX package's `load_clip_for_extraction` returns it, [1, T, 3, H, W] float32.
"""

from __future__ import annotations

import numpy as np
import torch

from tvts_torch.eval.embed import make_embed_fns


def extract_video_feature(model, clip, use_fused: bool = False) -> np.ndarray:
    """[1, out] float32 embedding of one clip through a TVTSv2's video tower,
    full keep set arange(N)."""
    cfg = model.cfg.vision
    device = next(model.parameters()).device
    clip = torch.as_tensor(clip, dtype=torch.float32, device=device)
    keep = torch.arange(cfg.patches_per_frame, device=device)[None]
    _, embed_video = make_embed_fns(model, use_fused=use_fused)
    return embed_video(clip, keep).float().cpu().numpy()
