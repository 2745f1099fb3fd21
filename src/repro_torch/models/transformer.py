"""Dense decoder assembly: segment plan, parameter specs, the full-sequence
forward (prefill), single-token decode, and the token-level head/tail
split that runs the JALAD cut inside the decode loop.

Text-only: positions are ``arange`` over the sequence, so a boundary
carries everything the tail needs. Each decode step takes one position a
row (``pos`` of shape ``(B,)``), so one batched call advances slots that
sit at different positions; the reference vmaps batch-1 decodes instead.
Caches are updated in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.types import ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models.init import spec, stack_tree, torch_dtype
from repro_torch.models.layers.norms import apply_norm, norm_spec


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    kind: str
    count: int          # layers in this segment


def default_pattern(cfg: ModelConfig) -> str:
    if cfg.block_pattern:
        return cfg.block_pattern
    if cfg.family == "moe":
        return "e" * cfg.num_layers
    return "d" * cfg.num_layers


def segment_plan(cfg: ModelConfig) -> List[Segment]:
    """Split the block pattern into contiguous same-kind runs. (The
    reference also interleaves zamba's shared attention block; that family
    is not ported, and ``param_specs`` refuses it.)"""
    pattern = default_pattern(cfg)
    out = []
    i = 0
    while i < len(pattern):
        j = i
        while j < len(pattern) and pattern[j] == pattern[i]:
            j += 1
        out.append(Segment(pattern[i], j - i))
        i = j
    return out


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's tree for a text-only decoder: ``embed``,
    ``final_norm``, ``segments`` (one stacked tree a segment) and
    ``lm_head`` unless the embeddings are tied."""
    if cfg.is_encdec or cfg.family == "vlm" or cfg.shared_attention_every:
        raise NotImplementedError(
            f"repro_torch: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md queue 1, item 4)")
    dt_ = cfg.param_dtype
    specs: Dict[str, Any] = {
        "embed": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), dt_,
                      init="embed", scale=0.02),
        "final_norm": norm_spec(cfg.norm_kind, cfg.d_model, dt_),
        "segments": [stack_tree(blk.block_spec(s.kind, cfg), s.count)
                     for s in segment_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = spec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt_, scale=0.02
        )
    return specs


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def effective_window(cfg: ModelConfig, seq_len: int) -> int:
    """Sliding-window size in effect for this sequence length."""
    if not cfg.attention_window:
        return 0
    if cfg.window_only_for_long and seq_len <= 32_768:
        return 0
    return cfg.attention_window


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(entries: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding. Returns (x, positions)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    return _embed(params, cfg, tokens), _positions(b, s, tokens.device)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    """A decode step's positions as a ``(B,)`` int64 tensor (an int or a
    scalar applies to every row)."""
    p = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return p.expand(b) if p.ndim == 0 else p


def _run_seq(params, cfg: ModelConfig, x: torch.Tensor, ctx: blk.SeqContext,
             ranges: List[Tuple[int, int, int]]) -> Tuple[torch.Tensor, List]:
    """Blocks of ``(segment, lo, hi)`` ranges over a sequence; the caches
    of each range stacked along the layer axis (None without cache_len)."""
    plan = segment_plan(cfg)
    caches: List[Any] = []
    for sj, lo, hi in ranges:
        entries = []
        for li in range(lo, hi):
            x, c = blk.block_apply_seq(plan[sj].kind,
                                       _layer(params["segments"][sj], li),
                                       x, ctx, cfg)
            entries.append(c)
        caches.append(_stack(entries) if ctx.cache_len else None)
    return x, caches


def _run_decode(params, cfg: ModelConfig, x: torch.Tensor,
                ctx: blk.DecodeContext, ranges: List[Tuple[int, int, int]],
                caches: List[Any]) -> torch.Tensor:
    """One token through the blocks of ``(segment, lo, hi)`` ranges; each
    range's stacked cache is updated in place."""
    plan = segment_plan(cfg)
    for (sj, lo, hi), cache in zip(ranges, caches):
        for j, li in enumerate(range(lo, hi)):
            x, _ = blk.block_apply_decode(plan[sj].kind,
                                          _layer(params["segments"][sj], li),
                                          x, _layer(cache, j), ctx, cfg)
    return x


def _all_ranges(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    return [(sj, 0, seg.count) for sj, seg in enumerate(segment_plan(cfg))]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def forward_seq(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
                cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[List[Any]]]:
    """Returns (logits, caches). ``cache_len`` > 0 builds decode caches
    (prefill mode)."""
    x, positions = embed_inputs(params, cfg, batch)
    ctx = blk.SeqContext(positions, effective_window(cfg, x.shape[1]),
                         cache_len)
    x, caches = _run_seq(params, cfg, x, ctx, _all_ranges(cfg))
    return _logits(params, cfg, x), (caches if cache_len else None)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _zero_caches(cfg: ModelConfig, batch: int, cache_len: int,
                 counts: List[Tuple[int, int]], device) -> List[Any]:
    plan = segment_plan(cfg)
    dtype = torch_dtype(cfg.dtype)
    caches = []
    for sj, count in counts:
        one = blk.init_block_cache(plan[sj].kind, cfg, batch, cache_len,
                                   dtype, device)
        caches.append({k: v.new_zeros((count,) + tuple(v.shape))
                       for k, v in one.items()})
    return caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device=None) -> List[Any]:
    """Zero decode caches; structure mirrors forward_seq's cache output."""
    return _zero_caches(cfg, batch, cache_len,
                        [(sj, s.count) for sj, s in
                         enumerate(segment_plan(cfg))], device)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos,
                caches: List[Any], live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
    """One decode step: tokens (B, 1), pos an int or (B,). Returns
    (logits (B, 1, V), caches), the caches updated in place."""
    x = _embed(params, cfg, tokens)
    ctx = blk.DecodeContext(_pos_rows(pos, x.shape[0], x.device),
                            effective_window(cfg, _decode_seq_hint(caches)),
                            live)
    x = _run_decode(params, cfg, x, ctx, _all_ranges(cfg), caches)
    return _logits(params, cfg, x), caches


def _decode_seq_hint(caches) -> int:
    """The nominal sequence length: the attention caches' length."""
    for seg_cache in caches:
        if isinstance(seg_cache, dict) and "k" in seg_cache:
            return seg_cache["k"].shape[-3]
    return 0


# ---------------------------------------------------------------------------
# Token-level head/tail split (streaming decode across the JALAD cut)
# ---------------------------------------------------------------------------
#
# Token streaming cuts the *decode loop*: every step the edge runs blocks
# [0, point], ships the (B, 1, d) boundary row, and the cloud resumes at
# block point+1, each side holding only its own caches. The functions below
# run the same blocks in the same order as forward_seq / decode_step, so the
# split loop equals the unsplit one bit for bit up to the boundary codec.


def point_to_segment(cfg: ModelConfig, point: int) -> Tuple[int, int]:
    """Map a global decoupling point to (segment index, offset in segment)."""
    acc = 0
    for si, seg in enumerate(segment_plan(cfg)):
        if point < acc + seg.count:
            return si, point - acc
        acc += seg.count
    raise IndexError(point)


def check_streamable(cfg: ModelConfig) -> None:
    """Families whose decode needs per-token extras beyond the boundary row
    (encoder output, vision positions) cannot stream over the cut."""
    if cfg.is_encdec or cfg.family == "vlm":
        raise ValueError(
            "token streaming ships only the boundary hidden row per token; "
            f"family {cfg.family!r} needs per-token extras (encoder output / "
            "vision positions) that are not part of the streaming wire format"
        )


def _head_ranges(cfg: ModelConfig, point: int) -> List[Tuple[int, int, int]]:
    """(segment, lo, hi) ranges the head runs, in order: every layer up to
    and including ``point``."""
    plan = segment_plan(cfg)
    si, off = point_to_segment(cfg, point)
    return [(sj, 0, plan[sj].count if sj < si else off + 1)
            for sj in range(si + 1)]


def _tail_ranges(cfg: ModelConfig, point: int) -> List[Tuple[int, int, int]]:
    """(segment, lo, hi) ranges the tail resumes at: the cut segment from
    ``off + 1``, then every later segment; empty ranges are skipped."""
    plan = segment_plan(cfg)
    si, off = point_to_segment(cfg, point)
    out = []
    for sj in range(si, len(plan)):
        lo = off + 1 if sj == si else 0
        if lo < plan[sj].count:
            out.append((sj, lo, plan[sj].count))
    return out


def init_head_caches(cfg: ModelConfig, batch: int, cache_len: int,
                     point: int, device=None) -> List[Any]:
    """Zero edge-side caches: blocks [0, point] only."""
    check_streamable(cfg)
    return _zero_caches(cfg, batch, cache_len,
                        [(sj, hi - lo) for sj, lo, hi in
                         _head_ranges(cfg, point)], device)


def init_tail_caches(cfg: ModelConfig, batch: int, cache_len: int,
                     point: int, device=None) -> List[Any]:
    """Zero cloud-side caches: blocks [point+1, end). Built from the
    cloud-side config, so ``cfg.kv_cache_bits == 8`` stores int8 codes +
    per-(position, kv-head) float32 scales."""
    check_streamable(cfg)
    return _zero_caches(cfg, batch, cache_len,
                        [(sj, hi - lo) for sj, lo, hi in
                         _tail_ranges(cfg, point)], device)


def prefill_head(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 cache_len: int, point: int
                 ) -> Tuple[torch.Tensor, List[Any]]:
    """Edge prefill: run blocks [0, point] over the prompt, building only
    the head's decode caches. Returns (boundary (B, S, d), head_caches)."""
    check_streamable(cfg)
    x, positions = embed_inputs(params, cfg, batch)
    ctx = blk.SeqContext(positions, effective_window(cfg, x.shape[1]),
                         cache_len)
    return _run_seq(params, cfg, x, ctx, _head_ranges(cfg, point))


def prefill_tail(params, cfg: ModelConfig, boundary: torch.Tensor,
                 cache_len: int, point: int
                 ) -> Tuple[torch.Tensor, List[Any]]:
    """Cloud prefill: resume at block point+1 from the decoded boundary,
    building the tail's decode caches. Positions are rebuilt from the
    boundary's shape. Returns (logits (B, S, V), tail_caches)."""
    check_streamable(cfg)
    b, s = boundary.shape[0], boundary.shape[1]
    ctx = blk.SeqContext(_positions(b, s, boundary.device),
                         effective_window(cfg, s), cache_len)
    x, caches = _run_seq(params, cfg, boundary, ctx, _tail_ranges(cfg, point))
    return _logits(params, cfg, x), caches


def decode_head(params, cfg: ModelConfig, tokens: torch.Tensor, pos,
                head_caches: List[Any], point: int, seq_hint: int,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
    """Edge half of one decode step: blocks [0, point] on one new token a
    row. ``seq_hint`` is the nominal sequence length (the shared cache
    length). Returns (boundary (B, 1, d), head caches, updated in place)."""
    x = _embed(params, cfg, tokens)
    ctx = blk.DecodeContext(_pos_rows(pos, x.shape[0], x.device),
                            effective_window(cfg, seq_hint), live)
    x = _run_decode(params, cfg, x, ctx, _head_ranges(cfg, point),
                    head_caches)
    return x, head_caches


def decode_tail(params, cfg: ModelConfig, boundary: torch.Tensor, pos,
                tail_caches: List[Any], point: int, seq_hint: int,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
    """Cloud half of one decode step: resume at block point+1 from the
    decoded (B, 1, d) boundary row. Returns (logits (B, 1, V), tail
    caches, updated in place)."""
    ctx = blk.DecodeContext(
        _pos_rows(pos, boundary.shape[0], boundary.device),
        effective_window(cfg, seq_hint), live)
    x = _run_decode(params, cfg, boundary, ctx, _tail_ranges(cfg, point),
                    tail_caches)
    return _logits(params, cfg, x), tail_caches


# ---------------------------------------------------------------------------
# One-shot split of a full forward (the calibration and one-shot serving)
# ---------------------------------------------------------------------------


def run_head(params, cfg: ModelConfig, batch, point: int) -> torch.Tensor:
    """Blocks [0, point] over the whole sequence, no caches: the boundary."""
    x, positions = embed_inputs(params, cfg, batch)
    ctx = blk.SeqContext(positions, effective_window(cfg, x.shape[1]), 0)
    return _run_seq(params, cfg, x, ctx, _head_ranges(cfg, point))[0]


def run_tail(params, cfg: ModelConfig, boundary: torch.Tensor,
             point: int) -> torch.Tensor:
    """Blocks (point, end) and the logits, from a whole-sequence boundary."""
    return prefill_tail(params, cfg, boundary, 0, point)[0]


def run_segment(params, cfg: ModelConfig, boundary: torch.Tensor,
                from_point: int, to_point: int) -> torch.Tensor:
    """Blocks (from_point, to_point] over a whole-sequence boundary."""
    b, s = boundary.shape[0], boundary.shape[1]
    ctx = blk.SeqContext(_positions(b, s, boundary.device),
                         effective_window(cfg, s), 0)
    tail = _tail_ranges(cfg, from_point)
    si2, off2 = point_to_segment(cfg, to_point)
    ranges = [(sj, lo, off2 + 1 if sj == si2 else hi)
              for sj, lo, hi in tail if sj <= si2]
    ranges = [(sj, lo, hi) for sj, lo, hi in ranges if lo < hi]
    return _run_seq(params, cfg, boundary, ctx, ranges)[0]


def run_heads(params, cfg: ModelConfig, batch,
              points) -> Dict[int, torch.Tensor]:
    """The boundaries at several points from ONE sweep: the activation
    after each wanted block, keyed by point."""
    want = set(points)
    x, positions = embed_inputs(params, cfg, batch)
    ctx = blk.SeqContext(positions, effective_window(cfg, x.shape[1]), 0)
    plan = segment_plan(cfg)
    taps: Dict[int, torch.Tensor] = {}
    point = 0
    for sj, lo, hi in _head_ranges(cfg, max(want)):
        for li in range(lo, hi):
            x, _ = blk.block_apply_seq(plan[sj].kind,
                                       _layer(params["segments"][sj], li),
                                       x, ctx, cfg)
            if point in want:
                taps[point] = x
            point += 1
    return taps
