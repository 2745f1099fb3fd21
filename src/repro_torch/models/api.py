"""Public model API of the port: ``build_model(cfg)`` returns a
:class:`Model` with the reference's decoupling surface (``forward``,
``decoupling_points``, ``run_head``, ``run_heads``, ``run_segment``,
``run_tail``, ``per_point_fmacs``, ``boundary_bytes``) for the paper's CNN
testbed and the dense decoder family, which also serves (``prefill``,
``decode_step``, ``init_caches``) and streams across a cut
(``prefill_head`` / ``prefill_tail``, ``decode_head`` / ``decode_tail``,
``init_head_caches`` / ``init_tail_caches``).

Parameters are nested dicts (and, for the decoder's segments, lists) of
tensors keyed like the reference's trees. Batches are dicts: ``"images"``
(B, 3, H, W) for a CNN, ``"tokens"`` (B, S) for a decoder (numpy arrays
are moved to the parameters' device by :func:`batch_to`).

One difference from the reference: a decoder's ``run_head`` returns the
boundary tensor alone. Text positions are ``arange`` over the sequence,
which the tail rebuilds from the boundary's shape, so there are no extras
to carry. Other model families are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.types import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn as cnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.init import materialize

# Families the port builds; the others raise in build_model.
PORTED_FAMILIES = ("cnn", "dense")


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch dict with every array as a tensor on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


@dataclass
class Model:
    cfg: ModelConfig
    specs: Any                                     # ParamSpec tree

    def __post_init__(self):
        self.is_lm = self.cfg.family != "cnn"
        self.layers = None if self.is_lm else cnn_lib.build_layers(self.cfg)

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict:
        """Random parameters from ``seed`` on ``device`` (default: cuda)."""
        return materialize(self.specs, seed, resolve_device(device))

    def param_count(self) -> int:
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            if isinstance(tree, list):
                return sum(count(v) for v in tree)
            return int(np.prod(tree.shape))

        return count(self.specs)

    # ------------------------------------------------------------ entries
    def forward(self, params, batch) -> torch.Tensor:
        if self.is_lm:
            return tf_lib.forward_seq(params, self.cfg, batch)[0]
        return cnn_lib.cnn_forward(self.layers, params, batch["images"])

    def decoupling_points(self) -> List[str]:
        if self.is_lm:
            return [f"seg{si}_{seg.kind}{li}"
                    for si, seg in enumerate(tf_lib.segment_plan(self.cfg))
                    for li in range(seg.count)]
        return [lyr.name for lyr in self.layers]

    def run_head(self, params, batch, point: int) -> torch.Tensor:
        """Run layers [0, point] and return the boundary activation."""
        if self.is_lm:
            return tf_lib.run_head(params, self.cfg, batch, point)
        return cnn_lib.cnn_forward(self.layers, params, batch["images"],
                                   upto=point + 1)

    def run_heads(self, params, batch, points) -> List[Tuple[Any, Any]]:
        """Boundaries at several points from ONE tapped forward sweep, as
        ``(boundary, None)`` pairs in ``points`` order."""
        pts = list(points)
        if not pts:
            return []
        if self.is_lm:
            taps = tf_lib.run_heads(params, self.cfg, batch, pts)
            return [(taps[p], None) for p in pts]
        want = set(pts)
        taps: Dict[int, torch.Tensor] = {}
        x = batch["images"]
        for i, lyr in enumerate(self.layers[: max(want) + 1]):
            x = lyr.apply(params[lyr.name], x)
            if i in want:
                taps[i] = x
        return [(taps[p], None) for p in pts]

    def run_tail(self, params, boundary, point: int,
                 extras: Optional[Any] = None) -> torch.Tensor:
        if self.is_lm:
            return tf_lib.run_tail(params, self.cfg, boundary, point)
        return cnn_lib.cnn_forward(self.layers, params, boundary,
                                   start=point + 1)

    def run_segment(self, params, boundary, from_point: int, to_point: int,
                    extras: Optional[Any] = None) -> torch.Tensor:
        """The middle tier of a three-way split: layers ``(from_point,
        to_point]`` on the boundary of ``run_head(..., from_point)``, so
        ``run_tail(run_segment(run_head(x, i1), i1, i2), i2)`` is the full
        forward. ``from_point == to_point`` (a relay) returns ``boundary``
        itself."""
        if to_point < from_point:
            raise ValueError(f"segment requires from_point <= to_point, got "
                             f"({from_point}, {to_point})")
        if to_point == from_point:
            return boundary
        if self.is_lm:
            return tf_lib.run_segment(params, self.cfg, boundary, from_point,
                                      to_point)
        return cnn_lib.cnn_forward(self.layers, params, boundary,
                                   start=from_point + 1, upto=to_point + 1)

    # ------------------------------------------------ serving (decoders)
    def _check_lm(self) -> None:
        if not self.is_lm:
            raise ValueError("KV-cache serving is autoregressive decode; "
                             "CNNs decouple per request (run_head/run_tail)")

    def prefill(self, params, batch, cache_len: int):
        """Prompt forward building decode caches: (logits, caches)."""
        self._check_lm()
        return tf_lib.forward_seq(params, self.cfg, batch,
                                  cache_len=cache_len)

    def decode_step(self, params, tokens, pos, caches, live=None):
        """One token a row at its own ``pos`` (an int or (B,)); the caches
        are updated in place (rows with ``live`` off keep theirs)."""
        return tf_lib.decode_step(params, self.cfg, tokens, pos, caches,
                                  live)

    def init_caches(self, batch: int, cache_len: int,
                    device: DeviceLike = None):
        self._check_lm()
        return tf_lib.init_caches(self.cfg, batch, cache_len,
                                  resolve_device(device))

    # -------------------------------------- token streaming (JALAD decode)
    def _check_token_split(self) -> None:
        if not self.is_lm:
            raise ValueError("token streaming is autoregressive decode; "
                             "CNNs decouple per request (run_head/run_tail)")
        tf_lib.check_streamable(self.cfg)

    def prefill_head(self, params, batch, cache_len: int, point: int):
        """Edge prefill of blocks [0, point]; returns (boundary, caches)."""
        self._check_token_split()
        return tf_lib.prefill_head(params, self.cfg, batch, cache_len, point)

    def prefill_tail(self, params, boundary, cache_len: int, point: int):
        """Cloud prefill resuming at block point+1 from the decoded
        boundary; returns (logits, caches)."""
        self._check_token_split()
        return tf_lib.prefill_tail(params, self.cfg, boundary, cache_len,
                                   point)

    def decode_head(self, params, tokens, pos, head_caches, point: int,
                    seq_hint: int, live=None):
        """Edge half of one decode step; returns (boundary (B,1,d), head
        caches)."""
        return tf_lib.decode_head(params, self.cfg, tokens, pos, head_caches,
                                  point, seq_hint, live)

    def decode_tail(self, params, boundary, pos, tail_caches, point: int,
                    seq_hint: int, live=None):
        """Cloud half of one decode step; returns (logits (B,1,V), tail
        caches)."""
        return tf_lib.decode_tail(params, self.cfg, boundary, pos,
                                  tail_caches, point, seq_hint, live)

    def init_head_caches(self, batch: int, cache_len: int, point: int,
                         device: DeviceLike = None):
        self._check_token_split()
        return tf_lib.init_head_caches(self.cfg, batch, cache_len, point,
                                       resolve_device(device))

    def init_tail_caches(self, batch: int, cache_len: int, point: int,
                         device: DeviceLike = None):
        self._check_token_split()
        return tf_lib.init_tail_caches(self.cfg, batch, cache_len, point,
                                       resolve_device(device))

    # --------------------------------------------------- latency model IO
    def per_point_fmacs(self, batch: int, seq_len: int = 0) -> List[float]:
        """FMACs of each decoupling segment (layer i's own compute)."""
        if self.is_lm:
            tokens = batch * seq_len
            return [f * tokens for f in _block_fmacs_per_token(self.cfg)]
        return [f * batch for f in cnn_lib.layer_fmacs(self.layers)]

    def boundary_bytes(self, batch: int, seq_len: int = 0,
                       bytes_per_val: int = 4) -> List[int]:
        """Raw boundary feature size after each decoupling point."""
        if self.is_lm:
            n = len(self.decoupling_points())
            return [batch * seq_len * self.cfg.d_model * bytes_per_val] * n
        return cnn_lib.feature_bytes(self.layers, batch, bytes_per_val)


def _block_fmacs_per_token(cfg: ModelConfig) -> List[float]:
    """Per-token FMACs of each dense block (weights touched once a token):
    the q/k/v and output projections plus the SwiGLU MLP."""
    d, hd = cfg.d_model, cfg.head_dim_
    h, kv = cfg.num_heads, cfg.num_kv_heads
    attn = d * (h + 2 * kv) * hd + h * hd * d
    dense_mlp = 3.0 * d * cfg.d_ff
    return [attn + dense_mlp for _ in tf_lib.default_pattern(cfg)]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"repro_torch: model family {cfg.family!r} is not yet ported "
            "(ROADMAP.md queue 1, item 4); the CNN testbed "
            "(vgg16/19, resnet50/101) and the dense decoders are")
    if cfg.family == "cnn":
        return Model(cfg=cfg, specs=cnn_lib.cnn_param_specs(cfg))
    return Model(cfg=cfg, specs=tf_lib.param_specs(cfg))
