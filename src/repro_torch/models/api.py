"""Public model API of the port: ``build_model(cfg)`` returns a
:class:`Model` with the reference's decoupling surface (``forward``,
``decoupling_points``, ``run_head``, ``run_heads``, ``run_segment``,
``run_tail``, ``per_point_fmacs``, ``boundary_bytes``) and the training
loss (``loss_fn``) for the paper's CNN testbed and every decoder family
(dense, moe, ssm, hybrid, vlm, audio), which also serve (``prefill``,
``decode_step``, ``init_caches``); the text families also stream across
a cut (``prefill_head`` / ``prefill_tail``, ``decode_head`` /
``decode_tail``, ``init_head_caches`` / ``init_tail_caches``).

Parameters are nested dicts (and, for the decoder's segments, lists) of
tensors keyed like the reference's trees. Batches are dicts: ``"images"``
(B, 3, H, W) for a CNN, ``"tokens"`` (B, S) for a decoder, with
``"vision_embeds"`` (B, n_vis, d) for a vlm and ``"src_frames"`` (B,
S_enc, d) for an encoder-decoder (numpy arrays are moved to the
parameters' device by :func:`batch_to`).

The one-shot split of a vlm or audio model carries the reference's
extras beside the boundary: ``run_head`` returns ``(boundary, extras)``
with ``extras = {"positions", "enc_out", "pos3d"}``, ``run_tail`` and
``run_segment`` take them, and ``run_segment`` returns ``(boundary2,
extras)``. They travel beside the wire blob, never inside it. One
difference from the reference: a text family's ``run_head`` (and
``run_segment``) returns the boundary tensor alone. Its positions are
``arange`` over the sequence, which the tail rebuilds from the boundary's
shape, so there are no extras to carry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.types import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn as cnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.init import (
    abstractify,
    logical_axes,
    materialize,
    torch_dtype,
)
from repro_torch.models.layers.mamba2 import mamba_dims

# Families the port builds; the others raise in build_model.
PORTED_FAMILIES = ("cnn", "dense", "moe", "ssm", "hybrid", "vlm", "audio")


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
        self.has_extras = self.is_lm and tf_lib.has_extras(self.cfg)
        self.layers = None if self.is_lm else cnn_lib.build_layers(self.cfg)

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device: DeviceLike = None,
             draw: str = "cpu") -> Dict:
        """Random parameters from ``seed`` on ``device`` (default: cuda),
        drawn on the CPU (the default: the same values on every device)
        or, with ``draw="device"``, on the device itself, a bounded chunk
        at a time (see :func:`repro_torch.models.init.materialize`)."""
        return materialize(self.specs, seed, resolve_device(device), draw)

    def abstract_params(self) -> Any:
        """The parameter tree as ``meta`` tensors: no allocation."""
        return abstractify(self.specs)

    def param_logical_axes(self) -> Any:
        return logical_axes(self.specs)

    def param_count(self) -> int:
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            if isinstance(tree, list):
                return sum(count(v) for v in tree)
            return int(np.prod(tree.shape))

        return count(self.specs)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.num_experts:
            per_expert = cfg.d_model * cfg.moe_d_ff_ * 3
            moe_layers = tf_lib.default_pattern(cfg).count("e")
            return total - moe_layers * (
                cfg.num_experts - cfg.experts_per_token) * per_expert
        return total

    # ------------------------------------------------------------ entries
    def loss_fn(self, params, batch) -> torch.Tensor:
        """The training loss, a float32 scalar: cross-entropy on
        ``labels`` for a CNN; for a decoder the next-token loss (a vlm's
        vision prefix skipped) plus ``router_aux_loss`` times the MoE
        blocks' load-balance loss."""
        cfg = self.cfg
        if not self.is_lm:
            logits = cnn_lib.cnn_forward(self.layers, params, batch["images"])
            lg = logits.float()
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1,
                                batch["labels"].long()[:, None])[:, 0]
            return (logz - gold).mean()
        logits, aux, _ = tf_lib.forward_seq(params, cfg, batch,
                                            want_aux=True)
        offset = 0
        if cfg.family == "vlm" and "vision_embeds" in batch:
            offset = batch["vision_embeds"].shape[1]
        return tf_lib.next_token_loss(logits, batch["tokens"], aux, cfg,
                                      text_offset=offset)

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

    def run_head(self, params, batch, point: int):
        """Run layers [0, point] and return the boundary activation, with
        the extras beside it for a vlm or audio model: ``(boundary,
        extras)``."""
        if self.is_lm:
            x, extras = tf_lib.run_head(params, self.cfg, batch, point)
            return (x, extras) if self.has_extras else x
        return cnn_lib.cnn_forward(self.layers, params, batch["images"],
                                   upto=point + 1)

    def run_heads(self, params, batch, points) -> List[Tuple[Any, Any]]:
        """Boundaries at several points from ONE tapped forward sweep, as
        ``(boundary, extras)`` pairs in ``points`` order (extras None but
        for a vlm or audio model)."""
        pts = list(points)
        if not pts:
            return []
        if self.is_lm:
            taps, extras = tf_lib.run_heads(params, self.cfg, batch, pts)
            extras = extras if self.has_extras else None
            return [(taps[p], extras) for p in pts]
        want = set(pts)
        taps: Dict[int, torch.Tensor] = {}
        x = batch["images"]
        for i, lyr in enumerate(self.layers[: max(want) + 1]):
            x = lyr.apply(params[lyr.name], x)
            if i in want:
                taps[i] = x
        return [(taps[p], None) for p in pts]

    def boundary_logical_axes(self, ndim: int):
        """Logical axis names of the boundary activation crossing the cut
        (rank ``ndim``). The meshed cloud worker pins these on entry:
        batch resolves to the "data" mesh axis per the rule table; the
        remaining activation dims (spatial / seq / embed) stay replicated
        so the sharded params carry the "model" axis."""
        if self.cfg.family == "cnn":
            return ("batch",) + (None,) * (ndim - 1)
        return ("batch", "seq", "embed")[:ndim] + (None,) * max(0, ndim - 3)

    def run_tail(self, params, boundary, point: int,
                 extras: Optional[Any] = None) -> torch.Tensor:
        if self.is_lm:
            return tf_lib.run_tail(params, self.cfg, boundary, point, extras)
        return cnn_lib.cnn_forward(self.layers, params, boundary,
                                   start=point + 1)

    def run_segment(self, params, boundary, from_point: int, to_point: int,
                    extras: Optional[Any] = None):
        """The middle tier of a three-way split: layers ``(from_point,
        to_point]`` on the boundary of ``run_head(..., from_point)``, so
        ``run_tail(run_segment(run_head(x, i1), i1, i2), i2)`` is the full
        forward. ``from_point == to_point`` (a relay) returns ``boundary``
        itself. A vlm or audio model returns ``(boundary2, extras)``, the
        same extras: positions and the encoder output do not depend on
        the cut."""
        if to_point < from_point:
            raise ValueError(f"segment requires from_point <= to_point, got "
                             f"({from_point}, {to_point})")
        if to_point == from_point:
            return (boundary, extras) if self.has_extras else boundary
        if self.is_lm:
            x = tf_lib.run_segment(params, self.cfg, boundary, from_point,
                                   to_point, extras)
            return (x, extras) if self.has_extras else x
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
        logits, _, caches = tf_lib.forward_seq(params, self.cfg, batch,
                                               cache_len=cache_len)
        return logits, caches

    def decode_step(self, params, tokens, pos, caches, live=None):
        """One token a row at its own ``pos`` (an int or (B,)); the caches
        are updated in place (rows with ``live`` off keep theirs)."""
        return tf_lib.decode_step(params, self.cfg, tokens, pos, caches,
                                  live)

    def init_caches(self, batch: int, cache_len: int,
                    device: DeviceLike = None, enc_len: int = 0):
        """Zero decode caches (a ``'c'`` block's cross K/V: ``enc_len``
        rows)."""
        self._check_lm()
        return tf_lib.init_caches(self.cfg, batch, cache_len,
                                  resolve_device(device), enc_len)

    # ------------------------------------------------------- input specs
    def cache_len_for(self, seq_len: int) -> int:
        w = tf_lib.effective_window(self.cfg, seq_len)
        return min(seq_len, w) if w else seq_len

    def enc_len_for(self, seq_len: int) -> int:
        return seq_len // 4 if self.cfg.is_encdec else 0

    def vis_len_for(self, seq_len: int) -> int:
        if self.cfg.family != "vlm":
            return 0
        return min(self.cfg.num_vision_tokens, max(seq_len // 4, 16))

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """The batch of one step of ``shape`` as ``meta`` tensors (shapes
        and dtypes, no allocation), for the dry run.

        train/prefill: the whole batch of sequences (and the modality
        stubs); decode: one new token a sequence, the position, and the
        caches of ``init_caches`` (built on ``meta``), whose shared ``'A'``
        segments carry a layer axis of 1 (see ``cache_logical_axes``)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        i32 = torch.int32
        act = torch_dtype(cfg.dtype)

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=meta)

        if cfg.family == "cnn":
            return {"images": spec((b, 3, cfg.image_size, cfg.image_size),
                                   torch.float32),
                    "labels": spec((b,), i32)}
        if shape.mode in ("train", "prefill"):
            batch: Dict[str, Any] = {}
            text_len = s
            if cfg.family == "vlm":
                n_vis = self.vis_len_for(s)
                text_len = s - n_vis
                batch["vision_embeds"] = spec((b, n_vis, cfg.d_model), act)
            batch["tokens"] = spec((b, text_len), i32)
            if cfg.is_encdec:
                batch["src_frames"] = spec((b, self.enc_len_for(s),
                                            cfg.d_model), act)
            return batch
        # decode: one token + caches of length cache_len_for(seq).
        caches = tf_lib.init_caches(cfg, b, self.cache_len_for(s), meta,
                                    self.enc_len_for(s))
        return {"tokens": spec((b, 1), i32), "pos": spec((), i32),
                "caches": caches}

    def batch_logical_axes(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Logical-axis tree matching ``input_specs(shape)``, consumed by
        :func:`repro_torch.sharding.rules.shardings_for_specs`."""
        cfg = self.cfg
        if cfg.family == "cnn":
            return {"images": ("batch", None, None, None),
                    "labels": ("batch",)}
        if shape.mode in ("train", "prefill"):
            axes: Dict[str, Any] = {"tokens": ("batch", "seq")}
            if cfg.family == "vlm":
                axes["vision_embeds"] = ("batch", "seq", "embed")
            if cfg.is_encdec:
                axes["src_frames"] = ("batch", "enc_seq", "embed")
            return axes
        return {"tokens": ("batch", None), "pos": (),
                "caches": tf_lib.cache_logical_axes(cfg)}

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

    # ------------------------------------------------------ step accounting
    def model_flops(self, tokens_or_samples: int) -> float:
        """6·N·D (dense) / 6·N_active·D (MoE); CNN: 2·FMACs."""
        if not self.is_lm:
            total = sum(cnn_lib.layer_fmacs(self.layers))
            return 2.0 * total * tokens_or_samples
        return 6.0 * self.active_param_count() * tokens_or_samples

    def analytic_step_flops(self, shape: ShapeConfig,
                            block_remat: bool = False) -> float:
        """Matrix-product FLOPs of one step of this shape (global, all
        devices), the reference's count in its order of operations, so
        both packages give the same float.

        fwd = matmul 2*FMACs + attention quadratic (the full score matrix,
        the masked half too; windowed: S*W); train = fwd * 3 (the backward
        2x), +1 fwd if per-block remat recomputes the forward."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if not self.is_lm:
            per = sum(cnn_lib.layer_fmacs(self.layers))
            fwd = 2.0 * per * b
            return fwd * (4.0 if block_remat else 3.0) \
                if shape.mode == "train" else fwd

        pattern = tf_lib.default_pattern(cfg)
        n_attn = sum(1 for k in pattern if k in ("d", "e", "c"))
        if cfg.shared_attention_every:
            n_attn += len(pattern) // cfg.shared_attention_every
        per_block = _block_fmacs_per_token(cfg)
        if shape.mode in ("train", "prefill"):
            tokens = b * s
            fwd = 2.0 * sum(per_block) * tokens
            w = tf_lib.effective_window(cfg, s)
            kv_len = min(s, w) if w else s
            fwd += 4.0 * b * cfg.num_heads * s * kv_len * cfg.head_dim_ \
                * n_attn
            if cfg.is_encdec:
                enc_s = self.enc_len_for(s)
                enc_tokens = b * enc_s
                enc_fmacs = (cfg.d_model * (cfg.num_heads
                                            + 2 * cfg.num_kv_heads)
                             * cfg.head_dim_
                             + cfg.num_heads * cfg.head_dim_ * cfg.d_model
                             + 2 * cfg.d_model * cfg.d_ff)
                fwd += 2.0 * enc_fmacs * enc_tokens * cfg.num_encoder_layers
                fwd += 4.0 * b * cfg.num_heads * enc_s * enc_s \
                    * cfg.head_dim_ * cfg.num_encoder_layers
                # cross attention over the encoder's keys
                fwd += 4.0 * b * cfg.num_heads * s * enc_s * cfg.head_dim_ \
                    * len(pattern)
            fwd += 2.0 * tokens * cfg.d_model * cfg.vocab_size   # logits
            if shape.mode == "prefill":
                return fwd
            return fwd * (4.0 if block_remat else 3.0)

        # decode: one token, attention reads the whole cache.
        fwd = 2.0 * sum(per_block) * b
        fwd += 4.0 * b * cfg.num_heads * self.cache_len_for(s) \
            * cfg.head_dim_ * n_attn
        if cfg.is_encdec:
            fwd += 4.0 * b * cfg.num_heads * self.enc_len_for(s) \
                * cfg.head_dim_ * len(pattern)
        fwd += 2.0 * b * cfg.d_model * cfg.vocab_size
        return fwd


def _block_fmacs_per_token(cfg: ModelConfig) -> List[float]:
    """Per-token FMACs of each block (weights touched once a token), in
    decoupling-point order: a shared attention block's after every
    ``shared_attention_every`` blocks."""
    d, hd = cfg.d_model, cfg.head_dim_
    h, kv = cfg.num_heads, cfg.num_kv_heads
    out: List[float] = []
    attn = d * (h + 2 * kv) * hd + h * hd * d       # qkv + out proj
    dense_mlp = 3.0 * d * cfg.d_ff
    moe_mlp = 3.0 * d * cfg.moe_d_ff_ * cfg.experts_per_token
    for kind in tf_lib.default_pattern(cfg):
        if kind == "e":             # the k routed experts and the router
            out.append(attn + moe_mlp + d * cfg.num_experts)
        elif kind in ("m", "M"):
            dims = mamba_dims(cfg)
            out.append(d * (2 * dims.d_inner + 2 * dims.state + dims.heads)
                       + dims.d_inner * d
                       + (dense_mlp if kind == "M" else 0.0))
        elif kind == "l":
            di = cfg.ssm_expand * d
            out.append(d * 2 * di + 3 * di * di + di * d)
        elif kind == "s":
            out.append(4 * d * d + 4 * d * (d // max(cfg.num_heads, 1))
                       + 2 * d * int(4 / 3 * d))
        elif kind == "c":
            # The reference's count: 3 d d_ff, though the GELU MLP has two
            # matrices.
            out.append(2 * attn + 3.0 * d * cfg.d_ff)
        else:
            out.append(attn + dense_mlp)
    if cfg.shared_attention_every:
        shared_cost = attn + dense_mlp
        merged: List[float] = []
        for i, c in enumerate(out):
            merged.append(c)
            if (i + 1) % cfg.shared_attention_every == 0:
                merged.append(shared_cost)
        out = merged
    return out


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; known: "
                         f"{', '.join(PORTED_FAMILIES)}")
    if cfg.family == "cnn":
        return Model(cfg=cfg, specs=cnn_lib.cnn_param_specs(cfg))
    return Model(cfg=cfg, specs=tf_lib.param_specs(cfg))
