"""Random erasing for video clips (counterpart of
tvts_tpu/downstream/random_erasing.py; reference v1/downstream/random_erasing.py,
timm lineage): with probability `probability`, erase a rectangle of 2-33% of
the area with a log-uniform aspect in [0.3, 3.3], filled with per-pixel
gaussian noise ('pixel') or zeros ('const'), the same region in every frame
(cube mode). It runs on the normalised float clip. Every value is drawn from
the given np.random.Generator in the JAX module's order: the gate, the count,
then per region up to 10 tries of (area, aspect) and the corner, then the fill.
"""

from __future__ import annotations

import math

import numpy as np


class RandomErasing:
    def __init__(self, probability: float = 0.25, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 mode: str = "pixel", max_count: int = 1, cube: bool = True,
                 rng: np.random.Generator | None = None):
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        self.log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))
        self.mode = mode
        self.max_count = max_count
        self.cube = cube  # the same region in every frame
        self.rng = rng or np.random.default_rng()

    def _region(self, h, w):
        area = h * w
        for _ in range(10):
            target = self.rng.uniform(self.min_area, self.max_area) * area
            aspect = math.exp(self.rng.uniform(*self.log_aspect))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(self.rng.integers(0, h - eh))
                left = int(self.rng.integers(0, w - ew))
                return top, left, eh, ew
        return None

    def _fill(self, shape):
        if self.mode == "pixel":
            return self.rng.normal(size=shape).astype(np.float32)
        if self.mode == "const":
            return np.zeros(shape, dtype=np.float32)
        raise ValueError(self.mode)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        """clip [T, C, H, W] float32 (normalised) -> an erased copy (or clip)."""
        if self.rng.random() > self.probability:
            return clip
        t, c, h, w = clip.shape
        clip = clip.copy()
        count = int(self.rng.integers(1, self.max_count + 1))
        for _ in range(count):
            reg = self._region(h, w)
            if reg is None:
                continue
            top, left, eh, ew = reg
            if self.cube:
                clip[:, :, top: top + eh, left: left + ew] = self._fill((t, c, eh, ew))
            else:
                for fi in range(t):
                    clip[fi, :, top: top + eh, left: left + ew] = self._fill((c, eh, ew))
        return clip
