"""Tube masking: drop a random subset of spatial patch positions, shared across
time (counterpart of tvts_tpu/ops/masking.py)."""

from __future__ import annotations

import numpy as np
import torch


def n_keep_patches(patches_per_frame: int, mask_ratio: float) -> int:
    return int(patches_per_frame * (1.0 - mask_ratio))


def make_tube_keep_indices(
    patches_per_frame: int,
    mask_ratio: float,
    rng: np.random.Generator | None = None,
    batch: int | None = None,
) -> np.ndarray:
    """Host-side random keep indices: first `n_keep` entries of a permutation.

    Returns [n_keep] int32, or [batch, n_keep] if `batch` is given. The same
    numpy calls as the JAX package, so one seed gives one keep set in both.
    """
    if rng is None:
        rng = np.random.default_rng()
    n_keep = n_keep_patches(patches_per_frame, mask_ratio)
    if batch is None:
        return rng.permutation(patches_per_frame)[:n_keep].astype(np.int32)
    return np.stack(
        [rng.permutation(patches_per_frame)[:n_keep] for _ in range(batch)]
    ).astype(np.int32)


def gather_tube_tokens(x_patch: torch.Tensor, keep_ind: torch.Tensor) -> torch.Tensor:
    """Apply a per-example spatial keep set to every frame.

    x_patch: [B, T, N, D]; keep_ind: [B, n_keep] indices into N.
    Returns [B, T, n_keep, D].
    """
    b, t, _, d = x_patch.shape
    idx = keep_ind.long()[:, None, :, None].expand(b, t, -1, d)
    return torch.gather(x_patch, 2, idx)
