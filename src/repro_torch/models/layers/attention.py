"""Attention: GQA/MQA/MHA with RoPE / M-RoPE, optional qk-norm, optional
sliding window, chunked (online-softmax) prefill, cross attention for
encoder-decoder models, and single-token decode against a KV cache (a
ring buffer in sliding-window mode), plus the int8 KV pair.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the
reference. One difference: a decode step takes ``pos`` as a ``(B,)``
tensor, one position per row, so one batched call advances slots that
sit at different positions (the reference vmaps batch-1 decodes, each
with a scalar ``pos``). Cache writes are in place, at each row's own
position; rows whose ``live`` flag is off keep their cache rows.

The chunked prefill's backward recomputes its score blocks, as the
reference's custom VJP does.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.types import ModelConfig, mup
from repro_torch.models.init import spec
from repro_torch.models.layers import rope as rope_lib
from repro_torch.sharding.activation import (
    _dtensor_module,
    constrain,
    local_view,
    shard_range,
)

_NEG_INF = -1e30
_QHEADS = ("batch", "seq", "heads", "head_dim")
_KVHEADS = ("batch", "seq", "kv_heads", "head_dim")
# The reference divides by 127.0 in quantize_kv_row; compiled XLA turns
# that into a multiplication by the float32 reciprocal, and the int8 codes
# and scales match the compiled reference bit for bit only so.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attention_spec(cfg: ModelConfig, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = {
        "wq": spec((d, h, hd), ("embed", "heads", "head_dim"), cfg.param_dtype),
        "wk": spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                   cfg.param_dtype),
        "wv": spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                   cfg.param_dtype),
        "wo": spec((h, hd, d), ("heads", "head_dim", "embed"), cfg.param_dtype),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = spec((hd,), ("head_dim",), cfg.param_dtype, init="ones")
        p["k_norm"] = spec((hd,), ("head_dim",), cfg.param_dtype, init="ones")
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * (ms + eps) ** -0.5) * scale.float()).to(x.dtype)


def _maybe_qk_norm(params, q, k, eps: float = 1e-6):
    if "q_norm" not in params:
        return q, k
    return _rms(q, params["q_norm"], eps), _rms(k, params["k_norm"], eps)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, rope: bool = True,
                positions_3d: Optional[torch.Tensor] = None):
    """Project to (q, k, v); applies qk-norm then RoPE/M-RoPE to q and k
    (M-RoPE at ``positions_3d``, or at the text ids of ``positions``),
    and a muP attention multiplier to q."""
    q = constrain(_proj(x, params["wq"]), _QHEADS)
    k = constrain(_proj(x, params["wk"]), _KVHEADS)
    v = constrain(_proj(x, params["wv"]), _KVHEADS)
    q, k = _maybe_qk_norm(params, q, k)
    if rope and cfg.rope_kind != "none":
        if cfg.rope_kind == "mrope":
            p3 = (positions_3d if positions_3d is not None
                  else rope_lib.text_positions_3d(positions))
            q = rope_lib.apply_mrope(q, p3, cfg.rope_theta,
                                     cfg.mrope_sections)
            k = rope_lib.apply_mrope(k, p3, cfg.rope_theta,
                                     cfg.mrope_sections)
        else:
            q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
            k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    if mup(cfg, "attention_multiplier"):
        # Every attention route scales scores by head_dim ** -0.5; q takes
        # the rest of a muP score scale (granite's 1/64 over 1/8: 2^-3,
        # exact in bfloat16), so no route changes.
        q = q * (mup(cfg, "attention_multiplier")
                 * math.sqrt(cfg.head_dim_))
    return q, k, v


# ---------------------------------------------------------------------------
# Dense (small-sequence) attention
# ---------------------------------------------------------------------------


def _split_gqa(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B,S,H,K) -> (B,S,kv,group,K)."""
    b, s, h, k = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, k)


def _on_head_shards(core, q, k, v, *rows):
    """``core(q, k, v, *rows)``; on a mesh, run on each rank's shard of
    the batch and the kv heads, the dims attention never mixes, and
    return a DTensor sharded the same way. DTensor's rules for the core's
    products would merge sharded dims (some versions refuse to flatten a
    sharded dim, ``aten.view``; others split a head group unevenly or
    plan strided shards). The layout is ``k``'s batch and kv-head splits;
    any other split (a cache on ``kv_seq``, heads split wider than the kv
    heads) is gathered first. ``rows`` are per-row tensors (B,), whole on
    every rank."""
    mod = _dtensor_module(k) or _dtensor_module(q)
    if mod is None:
        return core(q, k, v, *rows)
    mesh = (k if _dtensor_module(k) else q).device_mesh
    ref = k.placements if _dtensor_module(k) else [mod.Replicate()] * mesh.ndim
    want = [p if p.is_shard() and p.dim in (0, 2) else mod.Replicate()
            for p in ref]

    def laid(x):
        if _dtensor_module(x) is None:
            x = mod.DTensor.from_local(x, mesh, [mod.Replicate()] * mesh.ndim,
                                       run_check=False)
        return x if list(x.placements) == want else x.redistribute(mesh, want)

    q, k, v = laid(q), laid(k), laid(v)
    b0, nb = shard_range(k, 0)
    out = core(local_view(q), local_view(k), local_view(v),
               *[_whole(r)[b0:b0 + nb] for r in rows])
    return mod.DTensor.from_local(out, mesh, want, run_check=False)


def _whole(t):
    """A DTensor's whole value on every rank, or the tensor itself."""
    return t.full_tensor() if _dtensor_module(t) is not None else t


def _mask(sq: int, sk: int, q_offset, causal: bool, window: int,
          device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """Materialized-scores attention; fine for seq <= ~8k."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = _split_gqa(q, kvh)                                  # (B,Sq,kv,g,K)
    # Out of place: the product's output must stay as it is for a
    # selective checkpoint that keeps it (``remat="dots"``).
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float() * hd ** -0.5
    mask = _mask(sq, k.shape[1], q_offset, causal, window, q.device)
    scores = torch.where(mask[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b, sq, h, hd)


# ---------------------------------------------------------------------------
# Chunked (online-softmax) attention for long prefill, with a backward that
# recomputes the score blocks
# ---------------------------------------------------------------------------


# The chunked attention's query and key/value chunk.
CHUNK = 1024


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_chunk: int = CHUNK,
                      kv_chunk: int = CHUNK) -> torch.Tensor:
    """Flash attention: outer loop over query chunks, inner online softmax
    over key/value chunks. When a gradient is asked for, the call is an
    autograd Function whose backward RECOMPUTES each score block from
    ``q``, ``k``, ``v``, the output and the log-sum-exp (the reference's
    custom VJP), so both directions hold O(q_chunk * kv_chunk) per (batch,
    head): autograd through the loops would save every probability block,
    the full S^2 scores, for the backward."""
    b, s, h, hd = q.shape
    sk = k.shape[1]
    if causal and s != sk:
        raise ValueError("causal chunked attention requires sq == sk")
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, sk)
    if s % q_chunk or sk % kv_chunk:
        raise ValueError(
            f"seq q={s}/k={sk} not divisible by chunks {q_chunk}/{kv_chunk}"
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, window, q_chunk, kv_chunk)
    return _flash_forward(q, k, v, causal, window, q_chunk, kv_chunk)[0]


def _flash_forward(q, k, v, causal: bool, window: int, q_chunk: int,
                   kv_chunk: int, want_lse: bool = False):
    """(out (B, S, H, K), each query chunk's log-sum-exp (nq, B, kv, g,
    qc) in float32, or None unless ``want_lse``)."""
    b, s, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = _split_gqa(q, kvh)
    outs, lses = [], []
    for qi in range(s // q_chunk):
        qblk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]       # (B,qc,kv,g,K)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kvh, g, q_chunk), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_sum = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32,
                            device=q.device)
        for ki in range(sk // kv_chunk):
            kblk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vblk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s_blk = torch.einsum("bqhgk,bshk->bhgqs", qblk, kblk).float()
            s_blk = s_blk * scale
            mask = _mask(q_chunk, kv_chunk, qi * q_chunk - ki * kv_chunk,
                         causal, window, q.device)
            s_blk = torch.where(mask[None, None, None], s_blk, _NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqs,bshk->bhgqk", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
        outs.append(out.to(q.dtype))
        if want_lse:
            lses.append(m + torch.log(torch.clamp_min(l_sum, 1e-30)))
    # (nq, B, kv, g, qc, K) -> (B, S, H, K)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(b, s, h, hd), (torch.stack(lses) if want_lse
                                      else None)


def _flash_backward(q, k, v, out, lse, dout, causal: bool, window: int,
                    q_chunk: int, kv_chunk: int):
    """(dq, dk, dv) in the inputs' dtypes: each score block recomputed,
    ``p = exp(s - lse)``, ``ds = p * (dp - delta) * scale``, the three
    gradients summed in float32 in the reference's order."""
    b, s, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg, dg = _split_gqa(q, kvh), _split_gqa(dout, kvh)
    # delta_i = sum(dout * out) over head_dim: (B, kv, g, S)
    delta = torch.sum(dg.float() * _split_gqa(out, kvh).float(),
                      dim=-1).permute(0, 2, 3, 1)
    dq = torch.empty((b, s, kvh, g, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((b, sk, kvh, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for qi in range(s // q_chunk):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qblk, doblk = qg[:, rows], dg[:, rows]              # (B,qc,kv,g,K)
        lse_i, delta_i = lse[qi][..., None], delta[..., rows, None]
        dq_acc = torch.zeros((b, q_chunk, kvh, g, hd), dtype=torch.float32,
                             device=q.device)
        for ki in range(sk // kv_chunk):
            cols = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kblk, vblk = k[:, cols], v[:, cols]
            s_blk = torch.einsum("bqhgk,bshk->bhgqs", qblk, kblk).float()
            s_blk = s_blk * scale
            mask = _mask(q_chunk, kv_chunk, qi * q_chunk - ki * kv_chunk,
                         causal, window, q.device)
            s_blk = torch.where(mask[None, None, None], s_blk, _NEG_INF)
            p = torch.exp(s_blk - lse_i)                    # (B,kv,g,qc,kc)
            dp = torch.einsum("bqhgk,bshk->bhgqs", doblk, vblk).float()
            ds = p * (dp - delta_i) * scale
            dq_acc = dq_acc + torch.einsum(
                "bhgqs,bshk->bqhgk", ds.to(kblk.dtype), kblk).float()
            dk[:, cols] += torch.einsum(
                "bhgqs,bqhgk->bshk", ds.to(qblk.dtype), qblk).float()
            dv[:, cols] += torch.einsum(
                "bhgqs,bqhgk->bshk", p.to(doblk.dtype), doblk).float()
        dq[:, rows] = dq_acc
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward keeps ``q``,
    ``k``, ``v``, the output and the log-sum-exp, never a score block.
    Its forward runs with gradients off, so a selective checkpoint keeps
    none of its products (``training/loop.py`` ``_save_dots``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _flash_forward(q, k, v, causal, window, q_chunk,
                                  kv_chunk, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunking = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout, *ctx.chunking)
        return dq, dk, dv, None, None, None, None


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      dense_threshold: int = 2048) -> torch.Tensor:
    """Dense attention up to ``dense_threshold`` query positions (or for a
    causal call whose query and key lengths differ), chunked above. A
    causal length past one :data:`CHUNK` and not a multiple of it is
    padded to whole chunks (:func:`_padded`)."""
    s = q.shape[1]
    if s <= dense_threshold or (causal and s != k.shape[1]):
        core = functools.partial(full_attention, causal=causal,
                                 window=window)
    else:
        core = functools.partial(chunked_attention, causal=causal,
                                 window=window)
        if causal and s > CHUNK and s % CHUNK:
            core = _padded(core, -s % CHUNK)
    return _on_head_shards(core, q, k, v)


def _padded(core, pad: int):
    """A causal attention ``core`` over its sequence padded by ``pad``
    zero positions at the end: no real query reaches a pad (each sits
    after every real position), and the pads' own rows are dropped."""
    def run(q, k, v):
        s = q.shape[1]
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        return core(q, k, v)[:, :s]
    return run


# ---------------------------------------------------------------------------
# JALAD-quantized (int8) KV cache
# ---------------------------------------------------------------------------
#
# K/V rows are stored as int8 codes with one float32 amax-scale per (batch,
# position, kv_head): the symmetric variant q = round(127 * x / amax) of
# the paper's min-max quantizer.


def quantize_kv_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 codes, f32 scale over the trailing dim)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax, 1e-8) * _INV_127
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Decode against a KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer-stack KV cache. ``k``/``v``: (L, B, S_cache, kv_heads, hd).
    In sliding-window mode S_cache == window and writes wrap (ring buffer);
    keys are stored post-RoPE so slot order is irrelevant to attention."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def cache_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(num_layers: int, batch: int, cache_len: int, kv_heads: int,
                  head_dim: int, dtype, device=None) -> KVCache:
    shape = (num_layers, batch, cache_len, kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _write_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                live: Optional[torch.Tensor]) -> torch.Tensor:
    """``cache[b, pos[b] % S_c] = new[b, 0]`` for every row b (those with
    ``live[b]`` only, when given), in place; returns ``cache``."""
    if _dtensor_module(cache) is not None:
        return _write_rows_sharded(cache, new, pos, live)
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = torch.remainder(pos, cache.shape[1])
    new = new[:, 0].to(cache.dtype)
    if live is not None:
        keep = live.reshape((-1,) + (1,) * (new.ndim - 1))
        new = torch.where(keep, new, cache[rows, slot])
    cache[rows, slot] = new
    return cache


def _write_rows_sharded(cache, new, pos, live):
    """:func:`_write_rows` into a sharded cache (B, S_c, ...), on each
    rank's local shard: DTensor refuses an in-place ``index_put_`` into a
    sharded tensor. The new row takes the cache's layout without the
    sequence dim; a rank writes the rows of its batch shard whose slot
    falls in its shard of the sequence (a cache split on ``kv_seq``), and
    leaves the others as they were."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    want = []
    for p in cache.placements:
        if p.is_shard() and p.dim != 1:
            want.append(Shard(p.dim - 1 if p.dim > 1 else 0))
        else:
            want.append(Replicate())
    row = local_view(new[:, 0].to(cache.dtype).redistribute(mesh, want))
    local = cache.to_local()
    b0, nb = shard_range(cache, 0)
    s0, ns = shard_range(cache, 1)
    slot = torch.remainder(_whole(pos), cache.shape[1])[b0:b0 + nb]
    owned = (slot >= s0) & (slot < s0 + ns)
    if live is not None:
        owned = owned & _whole(live)[b0:b0 + nb]
    rows = torch.arange(nb, device=local.device)
    at = torch.clamp(slot - s0, 0, ns - 1)
    keep = owned.reshape((-1,) + (1,) * (row.ndim - 1))
    local[rows, at] = torch.where(keep, row, local[rows, at])
    return cache


def cache_update(k_cache, v_cache, k_new, v_new, pos, live=None):
    """Write one step at each row's ``pos`` (mod cache length -> ring
    buffer), in place.

    k_cache/v_cache: (B, S_c, kv, hd); k_new/v_new: (B, 1, kv, hd); pos:
    (B,); live: (B,) bool or None (every row)."""
    return (_write_rows(k_cache, k_new, pos, live),
            _write_rows(v_cache, v_new, pos, live))


def scale_update(s_cache: torch.Tensor, s_new: torch.Tensor, pos, live=None):
    """Write one step's (B, 1, kv) scale row at each row's pos (ring)."""
    return _write_rows(s_cache, s_new, pos, live)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); caches (B, S_c, kv, hd); length: (B,) valid
    positions of each row, the new one included."""
    return _on_head_shards(_decode_attention, q, k_cache, v_cache, length)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      length: torch.Tensor) -> torch.Tensor:
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    s_c = k_cache.shape[1]
    qg = _split_gqa(q, kvh)[:, 0]                            # (B,kv,g,K)
    scores = torch.einsum("bhgk,bshk->bhgs", qg, k_cache).float()
    scores *= hd ** -0.5
    valid = (torch.arange(s_c, device=q.device)[None]
             < torch.clamp_max(length, s_c)[:, None])        # (B, S_c)
    scores = torch.where(valid[:, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgs,bshk->bhgk", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def attn_output(params, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = params["wo"].shape
    return torch.matmul(out.flatten(-2), params["wo"].reshape(h * k, d))


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder): K/V from encoder output, no RoPE.
# ---------------------------------------------------------------------------


def cross_attention_kv(params, enc_out: torch.Tensor):
    return _proj(enc_out, params["wk"]), _proj(enc_out, params["wv"])


def cross_attention(params, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of ``x``'s queries over the encoder's keys (the
    two lengths differ; dense up to 2,048 queries, chunked above)."""
    q = _proj(x, params["wq"])
    out = prefill_attention(q, k, v, causal=False)
    return attn_output(params, out)
