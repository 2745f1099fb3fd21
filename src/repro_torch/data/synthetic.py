"""Deterministic synthetic image data (numpy only).

ILSVRC2012 is not available offline, so experiments run on seeded
synthetic streams: ``ImageStream`` is an ImageNet-like classification task
built from class-conditional Gabor-ish templates + noise. The code is the
reference's, so both packages draw identical batches from a seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.config.types import ModelConfig


@dataclass
class ImageStream:
    num_classes: int
    batch: int
    image_size: int = 32
    noise: float = 0.4
    seed: int = 0

    def _templates(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 1)
        hw = self.image_size
        yy, xx = np.mgrid[0:hw, 0:hw] / hw
        temps = []
        for c in range(self.num_classes):
            f1, f2 = rng.uniform(2, 8, 2)
            ph1, ph2 = rng.uniform(0, 2 * math.pi, 2)
            base = np.stack(
                [
                    np.sin(2 * math.pi * f1 * yy + ph1),
                    np.cos(2 * math.pi * f2 * xx + ph2),
                    np.sin(2 * math.pi * (f1 * yy + f2 * xx)),
                ]
            )
            temps.append(base)
        return np.stack(temps).astype(np.float32)      # (K, 3, H, W)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        temps = self._templates()
        while True:
            labels = rng.integers(0, self.num_classes, self.batch)
            imgs = temps[labels] + self.noise * rng.standard_normal(
                (self.batch, 3, self.image_size, self.image_size)
            ).astype(np.float32)
            yield {"images": imgs.astype(np.float32),
                   "labels": labels.astype(np.int32)}

    def batches(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0
               ) -> Dict[str, np.ndarray]:
    """One concrete host batch for a CNN config (images + labels)."""
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"repro_torch: batches for family {cfg.family!r} are not yet "
            "ported")
    stream = ImageStream(cfg.num_classes, batch, cfg.image_size, seed=seed)
    return next(iter(stream))
