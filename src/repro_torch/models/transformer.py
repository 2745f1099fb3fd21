"""Architecture assembly for every decoder family (dense, moe, ssm,
hybrid, vlm, audio): segment plan, parameter specs, the full-sequence
forward (prefill, and training with the MoE blocks' load-balance loss and
the next-token loss; ``cfg.block_remat`` checkpoints each block),
single-token decode, the one-shot head/tail split of a forward and the
token-level head/tail split that runs the JALAD cut inside the decode
loop.

A text family's positions are ``arange`` over the sequence, so a boundary
carries everything the tail needs. The vlm family prepends projected
vision embeddings and rotates by M-RoPE ids on an (h, w) grid; the audio
family runs an encoder over stub frame embeddings, whose output every
``'c'`` block cross-attends to. Those two families' one-shot split carries
the reference's extras beside the boundary, ``{"positions", "enc_out",
"pos3d"}``, and their decode loop cannot stream across a cut
(:func:`check_streamable`). Each decode step takes one position a row
(``pos`` of shape ``(B,)``), so one batched call advances slots that sit
at different positions; the reference vmaps batch-1 decodes instead.
Caches are updated in place.

A muP configuration (granite-4.0-h) scales the embedding by
``embedding_multiplier`` instead of ``sqrt(d_model)`` and divides the
logits by ``logits_scaling`` (``config.types.mup``).

A hybrid model (zamba2) invokes ONE shared attention block ``'A'`` after
every ``shared_attention_every`` blocks: its segments hold no parameters
(``{}``), every invocation reads ``params["shared_attn"]`` and keeps its
own KV cache. The port gives that cache a layer axis of 1 like every other
segment's (the reference's is unstacked), so one cache layout serves
every segment.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.types import ModelConfig, mup
from repro_torch.models import blocks as blk
from repro_torch.models.init import spec, stack_tree, torch_dtype
from repro_torch.models.layers.norms import apply_norm, norm_spec
from repro_torch.sharding.activation import (
    constrain,
    gather_dim,
    on_batch_shard,
)
from repro_torch.utils.scan import scan, stack_trees
from repro_torch.utils.tree import tree_map

_HID = ("batch", "seq", "embed")   # layer-boundary activation layout


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    kind: str
    count: int          # layers in this segment (1 for a shared 'A')
    shared: bool = False


def default_pattern(cfg: ModelConfig) -> str:
    if cfg.block_pattern:
        return cfg.block_pattern
    if cfg.family == "moe":
        return "e" * cfg.num_layers
    return "d" * cfg.num_layers


def segment_plan(cfg: ModelConfig) -> List[Segment]:
    """Split the block pattern into contiguous same-kind runs; interleave the
    zamba-style shared attention block every ``shared_attention_every``."""
    pattern = default_pattern(cfg)
    if cfg.shared_attention_every:
        period = cfg.shared_attention_every
        out: List[Segment] = []
        for i in range(0, len(pattern), period):
            run = pattern[i: i + period]
            out.append(Segment(run[0], len(run)))
            out.append(Segment("A", 1, shared=True))
        return out
    out = []
    i = 0
    while i < len(pattern):
        j = i
        while j < len(pattern) and pattern[j] == pattern[i]:
            j += 1
        out.append(Segment(pattern[i], j - i))
        i = j
    return out


def num_shared_invocations(plan: List[Segment]) -> int:
    return sum(1 for s in plan if s.shared)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's tree: ``embed``, ``final_norm``, ``segments`` (one
    stacked tree a segment, ``{}`` for a shared one), ``lm_head`` unless
    the embeddings are tied, the one ``shared_attn`` block of a hybrid
    model, a vlm's ``vision_proj`` and an encoder-decoder's ``encoder``
    (its ``'E'`` blocks stacked in one segment, and its final
    layernorm)."""
    dt_ = cfg.param_dtype
    specs: Dict[str, Any] = {
        "embed": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), dt_,
                      init="embed", scale=0.02),
        "final_norm": norm_spec(cfg.norm_kind, cfg.d_model, dt_),
        "segments": [{} if s.shared
                     else stack_tree(blk.block_spec(s.kind, cfg), s.count)
                     for s in segment_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = spec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt_, scale=0.02
        )
    if cfg.shared_attention_every:
        specs["shared_attn"] = blk.block_spec("A", cfg)
    if cfg.family == "vlm":
        specs["vision_proj"] = spec(
            (cfg.d_model, cfg.d_model), ("embed", "embed_out"), dt_
        )
    if cfg.is_encdec:
        specs["encoder"] = {
            "segments": [
                stack_tree(blk.block_spec("E", cfg), cfg.num_encoder_layers)
            ],
            "final_norm": norm_spec("layernorm", cfg.d_model, dt_),
        }
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


def _unstack(tree, count: int) -> List[Any]:
    """The ``count`` layers of a stacked tree (a parameterless norm's
    ``{}`` included), from one ``unbind`` a leaf: views, no copies, and a
    backward through them stacks the layers' gradients once, where a
    slice a layer would scatter each into a zero tensor of the whole
    stack."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(count)]
    return list(tree.unbind(0))


def _seg_layers(params, seg: Segment, sj: int) -> List[Any]:
    """The parameters of each layer of segment ``sj``: views of its
    stacked tree, or the one shared attention block."""
    if seg.shared:
        return [params["shared_attn"]] * seg.count
    return _unstack(params["segments"][sj], seg.count)


def _layers(params, seg: Segment, sj: int, lo: int, hi: int, step, carry,
            cache=None) -> Tuple[Any, Any]:
    """``step(carry, layer) -> (carry, y)`` over the layers ``[lo, hi)`` of
    segment ``sj``, ``layer`` a layer's parameters, or ``(parameters,
    cache entry)`` when ``cache`` (the range's stacked cache) is given:
    ``utils/scan.py``'s ``"layers"`` scan over the segment's stacked tree
    (sliced to the range when it is not the whole segment), or the one
    call of a shared block. The ys come back stacked on a leading layer
    axis."""
    if seg.shared:
        layer = params["shared_attn"]
        carry, y = step(carry, layer if cache is None
                        else (layer, _unstack(cache, 1)[0]))
        return carry, stack_trees([y], 0)
    tree = params["segments"][sj]
    if (lo, hi) != (0, seg.count):
        tree = tree_map(lambda a: a[lo:hi], tree)
    return scan(step, carry, tree if cache is None else (tree, cache),
                dim=0, loop="layers")


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    if cfg.tie_embeddings:
        lg = torch.matmul(x, params["embed"].t())
    else:
        lg = torch.matmul(x, params["lm_head"])
    if mup(cfg, "logits_scaling") != 1.0:
        lg = lg / mup(cfg, "logits_scaling")
    # Keep the (B, S, V) tensor vocab-sharded.
    return constrain(lg, ("batch", "seq", "vocab"))


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # On a mesh the lookup runs on each rank's batch shard, the table
    # gathered at use: some DTensor versions have no rule for an index
    # whose rows are split over two mesh dims ("pod" and "data").
    x = on_batch_shard(lambda p, t: p["embed"][t],
                       {"embed": params["embed"]}, tokens)
    scale = mup(cfg, "embedding_multiplier") or math.sqrt(cfg.d_model)
    return x * torch.tensor(scale, dtype=x.dtype)


def _vision_positions_3d(n_vis: int, text_len: int, batch: int,
                         device=None) -> torch.Tensor:
    """M-RoPE 3-D ids: vision tokens at t=0 on an h*w grid, then text tokens
    t = 1..text_len with h = w = t (Qwen2-VL convention, simplified)."""
    side = max(int(math.ceil(math.sqrt(n_vis))), 1)
    idx = torch.arange(n_vis, device=device)
    vis = torch.stack([torch.zeros_like(idx), idx // side, idx % side],
                      dim=-1)
    t = torch.arange(text_len, device=device) + 1
    txt = torch.stack([t, t, t], dim=-1)
    pos = torch.cat([vis, txt], dim=0)
    return pos[None].expand(batch, n_vis + text_len, 3)


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Token (+ modality-stub) embedding. Returns (x, positions, pos3d):
    a vlm batch with ``vision_embeds`` gets them projected (cast to the
    activation dtype first) in front of the tokens, and their M-RoPE ids;
    ``pos3d`` is None otherwise."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = torch.matmul(batch["vision_embeds"].to(x.dtype),
                           params["vision_proj"])
        n_vis = vis.shape[1]
        return (torch.cat([vis, x], dim=1),
                _positions(b, n_vis + s, tokens.device),
                _vision_positions_3d(n_vis, s, b, tokens.device))
    return x, _positions(b, s, tokens.device), None


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _apply_block(kind: str, params, x: torch.Tensor, ctx: blk.SeqContext,
                 cfg: ModelConfig):
    """One block over a sequence: ``block_apply_seq``, under activation
    checkpointing when ``cfg.block_remat`` (only the block's input is kept
    for the backward; its inside is recomputed)."""
    if cfg.block_remat:
        return checkpoint(blk.block_apply_seq, kind, params, x, ctx, cfg,
                          use_reentrant=False)
    return blk.block_apply_seq(kind, params, x, ctx, cfg)


def run_encoder(params, cfg: ModelConfig, src: torch.Tensor) -> torch.Tensor:
    """Seamless-style encoder over precomputed (stub) frame embeddings."""
    x = constrain(src.to(torch_dtype(cfg.dtype)), _HID)
    b, s, _ = x.shape
    ctx = blk.SeqContext(_positions(b, s, x.device), 0, 0)
    enc = params["encoder"]

    def layer(x, p):
        return constrain(_apply_block("E", p, x, ctx, cfg)[0], _HID), None

    x, _ = scan(layer, x, enc["segments"][0], dim=0, loop="layers")
    return apply_norm("layernorm", enc["final_norm"], x)


def has_extras(cfg: ModelConfig) -> bool:
    """Whether the one-shot split carries extras beside the boundary (the
    vlm's M-RoPE ids, the audio encoder's output)."""
    return cfg.is_encdec or cfg.family == "vlm"


def _seq_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The embedded input and the extras of a whole-sequence pass:
    ``{"positions", "enc_out", "pos3d"}`` (the encoder runs first)."""
    enc_out = None
    if cfg.is_encdec:
        enc_out = run_encoder(params, cfg, batch["src_frames"])
    x, positions, pos3d = embed_inputs(params, cfg, batch)
    return constrain(x, _HID), {"positions": positions, "enc_out": enc_out,
                                "pos3d": pos3d}


def _seq_ctx(cfg: ModelConfig, s: int, extras: Dict[str, Any],
             cache_len: int = 0, want_aux: bool = False) -> blk.SeqContext:
    return blk.SeqContext(extras["positions"], effective_window(cfg, s),
                          cache_len, extras.get("pos3d"),
                          extras.get("enc_out"), want_aux)


def _boundary_ctx(cfg: ModelConfig, boundary: torch.Tensor,
                  extras: Optional[Dict[str, Any]],
                  cache_len: int = 0) -> blk.SeqContext:
    """The context of a pass that resumes from a boundary: the extras' own,
    or (text families, no extras) positions rebuilt from its shape."""
    b, s = boundary.shape[0], boundary.shape[1]
    if extras is None:
        if has_extras(cfg):
            raise ValueError(
                f"family {cfg.family!r} resumes from a boundary only with "
                "the extras (positions, enc_out, pos3d) its head returned")
        extras = {"positions": _positions(b, s, boundary.device)}
    return _seq_ctx(cfg, s, extras, cache_len)


def _decode_ctx(cfg: ModelConfig, pos, b: int, device, window: int,
                live: Optional[torch.Tensor]) -> blk.DecodeContext:
    """A decode step's context; M-RoPE ids ``(p, p, p)`` for each row's
    own position (the reference lifts its one scalar ``pos``)."""
    rows = _pos_rows(pos, b, device)
    pos3d = None
    if cfg.rope_kind == "mrope":
        p = rows[:, None]
        pos3d = torch.stack([p, p, p], dim=-1)
    return blk.DecodeContext(rows, window, live, pos3d)


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    """A decode step's positions as a ``(B,)`` int64 tensor (an int or a
    scalar applies to every row)."""
    p = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return p.expand(b) if p.ndim == 0 else p


def _run_seq(params, cfg: ModelConfig, x: torch.Tensor, ctx: blk.SeqContext,
             ranges: List[Tuple[int, int, int]]
             ) -> Tuple[torch.Tensor, List, Optional[torch.Tensor]]:
    """Blocks of ``(segment, lo, hi)`` ranges over a sequence: the output,
    the caches of each range stacked along the layer axis (None without
    cache_len), and with ``ctx.want_aux`` the float32 sum of the MoE
    blocks' load-balance losses, added block by block in order (the
    reference's scan carry); None without it, and nothing computed."""
    plan = segment_plan(cfg)
    caches: List[Any] = []
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if ctx.want_aux else None)
    for sj, lo, hi in ranges:
        def block(carry, layer, kind=plan[sj].kind):
            x, aux_total = carry
            x, aux, c = _apply_block(kind, layer, x, ctx, cfg)
            x = constrain(x, _HID)
            if aux is not None:
                aux_total = aux_total + aux
            return (x, aux_total), c

        (x, aux_total), c = _layers(params, plan[sj], sj, lo, hi, block,
                                    (x, aux_total))
        caches.append(c)
    return x, caches, aux_total


def _run_decode(params, cfg: ModelConfig, x: torch.Tensor,
                ctx: blk.DecodeContext, ranges: List[Tuple[int, int, int]],
                caches: List[Any]) -> torch.Tensor:
    """One token through the blocks of ``(segment, lo, hi)`` ranges; each
    range's stacked cache is updated in place."""
    plan = segment_plan(cfg)
    for (sj, lo, hi), cache in zip(ranges, caches):
        def block(x, xs, kind=plan[sj].kind):
            x, _ = blk.block_apply_decode(kind, xs[0], x, xs[1], ctx, cfg)
            return constrain(x, _HID), None

        x, _ = _layers(params, plan[sj], sj, lo, hi, block, x, cache)
    return x


def _all_ranges(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    return [(sj, 0, seg.count) for sj, seg in enumerate(segment_plan(cfg))]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def forward_seq(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
                cache_len: int = 0, want_aux: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[List[Any]]]:
    """Returns (logits, aux, caches). ``cache_len`` > 0 builds decode
    caches (prefill mode); ``want_aux`` (training) gives ``aux``, the
    float32 sum of the MoE blocks' load-balance losses (zero for a model
    without ``'e'`` blocks), None without it."""
    x, extras = _seq_inputs(params, cfg, batch)
    ctx = _seq_ctx(cfg, x.shape[1], extras, cache_len, want_aux)
    x, caches, aux = _run_seq(params, cfg, x, ctx, _all_ranges(cfg))
    return _logits(params, cfg, x), aux, (caches if cache_len else None)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _init_cache_list(cfg: ModelConfig, batch: int, cache_len: int,
                     counts: List[Tuple[int, int]], device,
                     enc_len: int = 0) -> List[Any]:
    """Each segment's initial cache entry repeated along a leading layer
    axis of ``count`` (zeros, and an mLSTM / sLSTM stabilizer's -1e30)."""
    plan = segment_plan(cfg)
    dtype = torch_dtype(cfg.dtype)
    caches = []
    for sj, count in counts:
        one = blk.init_block_cache(plan[sj].kind, cfg, batch, cache_len,
                                   dtype, device, enc_len)
        caches.append({k: v.expand((count,) + tuple(v.shape)).clone()
                       for k, v in one.items()})
    return caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device=None, enc_len: int = 0) -> List[Any]:
    """Zero decode caches; structure mirrors forward_seq's cache output
    (a ``'c'`` block's cross K/V has ``enc_len`` rows)."""
    return _init_cache_list(cfg, batch, cache_len,
                            [(sj, s.count) for sj, s in
                             enumerate(segment_plan(cfg))], device, enc_len)


def cache_logical_axes(cfg: ModelConfig) -> List[Any]:
    """Logical-axis tree mirroring ``init_caches`` output structure: each
    segment's entry axes behind a leading ``"layers"``. A shared ``'A'``
    segment's cache has a layer axis of 1 here (``init_caches``), so its
    axes carry ``"layers"`` too, where the reference's unstacked entry has
    none."""
    return [{k: ("layers",) + a
             for k, a in blk.block_cache_axes(seg.kind, cfg).items()}
            for seg in segment_plan(cfg)]


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos,
                caches: List[Any], live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
    """One decode step: tokens (B, 1), pos an int or (B,). Returns
    (logits (B, 1, V), caches), the caches updated in place."""
    x = constrain(_embed(params, cfg, tokens), _HID)
    ctx = _decode_ctx(cfg, pos, x.shape[0], x.device,
                      effective_window(cfg, _decode_seq_hint(caches)), live)
    x = _run_decode(params, cfg, x, ctx, _all_ranges(cfg), caches)
    return _logits(params, cfg, x), caches


def _decode_seq_hint(caches) -> int:
    """The nominal sequence length: the attention caches' length (used only
    to pick the window; attention-free models return 0)."""
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
    if has_extras(cfg):
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
    return _init_cache_list(cfg, batch, cache_len,
                        [(sj, hi - lo) for sj, lo, hi in
                         _head_ranges(cfg, point)], device)


def init_tail_caches(cfg: ModelConfig, batch: int, cache_len: int,
                     point: int, device=None) -> List[Any]:
    """Zero cloud-side caches: blocks [point+1, end). Built from the
    cloud-side config, so ``cfg.kv_cache_bits == 8`` stores int8 codes +
    per-(position, kv-head) float32 scales."""
    check_streamable(cfg)
    return _init_cache_list(cfg, batch, cache_len,
                        [(sj, hi - lo) for sj, lo, hi in
                         _tail_ranges(cfg, point)], device)


def prefill_head(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 cache_len: int, point: int
                 ) -> Tuple[torch.Tensor, List[Any]]:
    """Edge prefill: run blocks [0, point] over the prompt, building only
    the head's decode caches. Returns (boundary (B, S, d), head_caches)."""
    check_streamable(cfg)
    x, extras = _seq_inputs(params, cfg, batch)
    ctx = _seq_ctx(cfg, x.shape[1], extras, cache_len)
    return _run_seq(params, cfg, x, ctx, _head_ranges(cfg, point))[:2]


def prefill_tail(params, cfg: ModelConfig, boundary: torch.Tensor,
                 cache_len: int, point: int
                 ) -> Tuple[torch.Tensor, List[Any]]:
    """Cloud prefill: resume at block point+1 from the decoded boundary,
    building the tail's decode caches. Positions are rebuilt from the
    boundary's shape. Returns (logits (B, S, V), tail_caches)."""
    check_streamable(cfg)
    ctx = _boundary_ctx(cfg, boundary, None, cache_len)
    x, caches, _ = _run_seq(params, cfg, constrain(boundary, _HID), ctx,
                            _tail_ranges(cfg, point))
    return _logits(params, cfg, x), caches


def decode_head(params, cfg: ModelConfig, tokens: torch.Tensor, pos,
                head_caches: List[Any], point: int, seq_hint: int,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
    """Edge half of one decode step: blocks [0, point] on one new token a
    row. ``seq_hint`` is the nominal sequence length (the shared cache
    length). Returns (boundary (B, 1, d), head caches, updated in place)."""
    x = constrain(_embed(params, cfg, tokens), _HID)
    ctx = _decode_ctx(cfg, pos, x.shape[0], x.device,
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
    ctx = _decode_ctx(cfg, pos, boundary.shape[0], boundary.device,
                      effective_window(cfg, seq_hint), live)
    x = _run_decode(params, cfg, constrain(boundary, _HID), ctx,
                    _tail_ranges(cfg, point), tail_caches)
    return _logits(params, cfg, x), tail_caches


# ---------------------------------------------------------------------------
# One-shot split of a full forward (the calibration and one-shot serving)
# ---------------------------------------------------------------------------
#
# Each returns or takes the extras of ``_seq_inputs`` (None where a text
# family resumes: its positions are rebuilt from the boundary's shape).


def run_head(params, cfg: ModelConfig, batch, point: int
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Blocks [0, point] over the whole sequence, no caches: (the
    boundary, the extras)."""
    x, extras = _seq_inputs(params, cfg, batch)
    ctx = _seq_ctx(cfg, x.shape[1], extras)
    return _run_seq(params, cfg, x, ctx, _head_ranges(cfg, point))[0], extras


def run_tail(params, cfg: ModelConfig, boundary: torch.Tensor, point: int,
             extras: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Blocks (point, end) and the logits, from a whole-sequence boundary."""
    ctx = _boundary_ctx(cfg, boundary, extras)
    x = _run_seq(params, cfg, boundary, ctx, _tail_ranges(cfg, point))[0]
    return _logits(params, cfg, x)


def run_segment(params, cfg: ModelConfig, boundary: torch.Tensor,
                from_point: int, to_point: int,
                extras: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Blocks (from_point, to_point] over a whole-sequence boundary."""
    ctx = _boundary_ctx(cfg, boundary, extras)
    tail = _tail_ranges(cfg, from_point)
    si2, off2 = point_to_segment(cfg, to_point)
    ranges = [(sj, lo, off2 + 1 if sj == si2 else hi)
              for sj, lo, hi in tail if sj <= si2]
    ranges = [(sj, lo, hi) for sj, lo, hi in ranges if lo < hi]
    return _run_seq(params, cfg, boundary, ctx, ranges)[0]


def run_heads(params, cfg: ModelConfig, batch, points
              ) -> Tuple[Dict[int, torch.Tensor], Dict[str, Any]]:
    """The boundaries at several points from ONE sweep: the activation
    after each wanted block, keyed by point, and the sweep's extras."""
    want = set(points)
    x, extras = _seq_inputs(params, cfg, batch)
    ctx = _seq_ctx(cfg, x.shape[1], extras)
    plan = segment_plan(cfg)
    taps: Dict[int, torch.Tensor] = {}
    point = 0
    for sj, lo, hi in _head_ranges(cfg, max(want)):
        for layer in _seg_layers(params, plan[sj], sj)[lo:hi]:
            x = blk.block_apply_seq(plan[sj].kind, layer, x, ctx, cfg)[0]
            if point in want:
                taps[point] = x
            point += 1
    return taps, extras


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    aux: torch.Tensor, cfg: ModelConfig,
                    text_offset: int = 0) -> torch.Tensor:
    """Causal LM loss in float32; ``text_offset`` skips modality-prefix
    positions (a vlm's vision tokens)."""
    lg = logits[:, text_offset:, :]
    # On a mesh the vocab is gathered at use: DTensor's gather over a
    # vocab-sharded dim keeps a mask buffer on its cached placement, which
    # breaks once that placement is reused.
    pred = gather_dim(lg[:, :-1].float(), -1)
    tgt = tokens[:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + cfg.router_aux_loss * aux
