"""Training losses (counterpart of tvts_tpu/ops/losses.py).

- `norm_softmax_loss`: reference v2/model/loss.py:7-25 (NormSoftmaxLoss,
  temperature 0.05): symmetric log-softmax over the similarity matrix,
  negative mean of both diagonals; for a non-square matrix the main diagonal
  of length min(N, M), as `torch.diag` takes it.
- `sort_loss`: reference v2/trainer/trainer.py:487-492: cross-entropy of the
  [B, n, n] sort logits against [B, n] integer labels, flattened, times 2.
- `sort_accuracy`: a sample counts only if every clip position is right.
The losses are taken in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def norm_softmax_loss(sim: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over a cosine-similarity matrix (diagonal = positives)."""
    x = sim.float() / temperature
    loss_i = F.log_softmax(x, dim=1).diagonal().mean()
    loss_j = F.log_softmax(x.T, dim=1).diagonal().mean()
    return -loss_i - loss_j


def sort_loss(pred_order: torch.Tensor, labels: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """pred_order [B, n, n] logits (row i scores transcript i's clip position),
    labels [B, n] int targets."""
    n = pred_order.shape[-1]
    return scale * F.cross_entropy(pred_order.reshape(-1, n).float(), labels.reshape(-1).long())


def sort_accuracy(pred_order: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Exact-match accuracy of the sort head (reference trainer.py:585-588)."""
    return (pred_order.argmax(-1) == labels).all(-1).float().mean()
