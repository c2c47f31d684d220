"""Cosine similarity matrix (counterpart of tvts_tpu/ops/sim.py): rows and
columns L2-normalised with the norm clamped below at `eps` (the norm is
replaced by max(norm, eps), not norm + eps)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] cosine similarities."""
    return l2_normalize(a, eps) @ l2_normalize(b, eps).T
