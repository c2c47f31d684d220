"""Mixup / CutMix with soft targets (counterpart of
tvts_tpu/downstream/mixup.py; reference v1/downstream/mixup.py, timm's Mixup
in batch mode as run_class_finetuning.py configures it: mixup alpha 0.8,
cutmix alpha 1.0, switch probability 0.5, label smoothing 0.1). The batch is
mixed with its reverse; cutmix pastes a box of the reversed batch and
recomputes lam from the box's clipped area. numpy on the host, the JAX
module's draws from the same np.random.Generator in the same order.
"""

from __future__ import annotations

import numpy as np


def one_hot(labels: np.ndarray, num_classes: int, smoothing: float = 0.0,
            lam: float = 1.0, flipped: np.ndarray | None = None) -> np.ndarray:
    """Smoothed one-hot targets [B, num_classes] float32; with `flipped`,
    lam * y + (1 - lam) * y(flipped)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y = np.full((len(labels), num_classes), off, dtype=np.float32)
    y[np.arange(len(labels)), labels] = on
    if flipped is not None:
        y2 = np.full_like(y, off)
        y2[np.arange(len(labels)), flipped] = on
        y = lam * y + (1.0 - lam) * y2
    return y


def _rand_bbox(h, w, lam, rng):
    ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return y1, y2, x1, x2


class Mixup:
    def __init__(self, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.1, num_classes: int = 174,
                 rng: np.random.Generator | None = None):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.rng = rng or np.random.default_rng()

    def __call__(self, video: np.ndarray, labels: np.ndarray):
        """video [B, T, C, H, W] float32, labels [B] int -> (mixed video,
        soft targets [B, num_classes])."""
        labels = np.asarray(labels)
        if self.rng.random() > self.prob or (self.mixup_alpha <= 0 and self.cutmix_alpha <= 0):
            return video, one_hot(labels, self.num_classes, self.label_smoothing)

        use_cutmix = (self.cutmix_alpha > 0 and
                      (self.mixup_alpha <= 0 or self.rng.random() < self.switch_prob))
        alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
        lam = float(self.rng.beta(alpha, alpha))

        flipped_video = video[::-1].copy()
        flipped_labels = labels[::-1].copy()
        if use_cutmix:
            h, w = video.shape[-2:]
            y1, y2, x1, x2 = _rand_bbox(h, w, lam, self.rng)
            mixed = video.copy()
            mixed[..., y1:y2, x1:x2] = flipped_video[..., y1:y2, x1:x2]
            lam = 1.0 - ((y2 - y1) * (x2 - x1) / (h * w))
        else:
            mixed = lam * video + (1.0 - lam) * flipped_video
        targets = one_hot(labels, self.num_classes, self.label_smoothing,
                          lam=lam, flipped=flipped_labels)
        return mixed.astype(video.dtype), targets
