"""Deterministic synthetic data (numpy only).

ILSVRC2012 is not available offline, so experiments run on seeded
synthetic streams:

* ``TokenStream`` — language-model token batches from a Zipfian unigram +
  Markov-ish bigram mixture.
* ``ImageStream`` — an ImageNet-like classification task built from
  class-conditional Gabor-ish templates + noise.

The code is the reference's, so both packages draw identical batches from
a seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.config.types import ModelConfig


@dataclass
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        # Zipf unigram distribution.
        ranks = np.arange(1, self.vocab_size + 1)
        p = 1.0 / ranks
        p /= p.sum()
        # Deterministic "bigram" shift: token t+1 is correlated with t.
        shift = rng.integers(1, self.vocab_size, size=self.vocab_size)
        while True:
            first = rng.choice(self.vocab_size, size=(self.batch, 1), p=p)
            toks = [first]
            for _ in range(self.seq_len - 1):
                prev = toks[-1]
                fresh = rng.choice(self.vocab_size, size=(self.batch, 1), p=p)
                follow = (prev + shift[prev]) % self.vocab_size
                use_follow = rng.random((self.batch, 1)) < 0.7
                toks.append(np.where(use_follow, follow, fresh))
            yield {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}

    def batches(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]


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
    """One concrete host batch: images + labels for a CNN, tokens (plus
    the modality stubs of the vlm and audio families) for the others."""
    rng = np.random.default_rng(seed)
    if cfg.family == "cnn":
        stream = ImageStream(cfg.num_classes, batch, cfg.image_size,
                             seed=seed)
        return next(iter(stream))
    out: Dict[str, np.ndarray] = {}
    text_len = seq_len
    if cfg.family == "vlm":
        n_vis = min(cfg.num_vision_tokens, max(seq_len // 4, 16))
        text_len = seq_len - n_vis
        out["vision_embeds"] = rng.standard_normal(
            (batch, n_vis, cfg.d_model)
        ).astype(np.float32)
    out["tokens"] = rng.integers(
        0, cfg.vocab_size, (batch, text_len)
    ).astype(np.int32)
    if cfg.is_encdec:
        out["src_frames"] = rng.standard_normal(
            (batch, max(seq_len // 4, 8), cfg.d_model)
        ).astype(np.float32) * 0.1
    return out
