"""Attention: GQA/MQA/MHA with RoPE, optional qk-norm, optional sliding
window, chunked (online-softmax) prefill, and single-token decode against
a KV cache (a ring buffer in sliding-window mode), plus the int8 KV pair.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the
reference. One difference: a decode step takes ``pos`` as a ``(B,)``
tensor, one position per row, so one batched call advances slots that
sit at different positions (the reference vmaps batch-1 decodes, each
with a scalar ``pos``). Cache writes are in place, at each row's own
position; rows whose ``live`` flag is off keep their cache rows.

Not ported: the flash backward (no training in the port) and cross
attention (encoder-decoder models).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.types import ModelConfig
from repro_torch.models.init import spec
from repro_torch.models.layers import rope as rope_lib

_NEG_INF = -1e30
# The reference divides by 127.0 in quantize_kv_row; compiled XLA turns
# that into a multiplication by the float32 reciprocal, and the int8 codes
# and scales match the compiled reference bit for bit only so.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attention_spec(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = {
        "wq": spec((d, h, hd), ("embed", "heads", "head_dim"), cfg.param_dtype),
        "wk": spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                   cfg.param_dtype),
        "wv": spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                   cfg.param_dtype),
        "wo": spec((h, hd, d), ("heads", "head_dim", "embed"), cfg.param_dtype),
    }
    if cfg.qk_norm:
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
                cfg: ModelConfig, *, rope: bool = True):
    """Project to (q, k, v); applies qk-norm then RoPE to q and k."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q, k = _maybe_qk_norm(params, q, k)
    if rope and cfg.rope_kind != "none":
        if cfg.rope_kind != "rope":
            raise NotImplementedError(
                f"repro_torch: rope_kind {cfg.rope_kind!r} is not ported "
                "(M-RoPE comes with the VLM family)")
        q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
        k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Dense (small-sequence) attention
# ---------------------------------------------------------------------------


def _split_gqa(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B,S,H,K) -> (B,S,kv,group,K)."""
    b, s, h, k = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, k)


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
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float()
    scores *= hd ** -0.5
    mask = _mask(sq, k.shape[1], q_offset, causal, window, q.device)
    scores = torch.where(mask[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b, sq, h, hd)


# ---------------------------------------------------------------------------
# Chunked (online-softmax) attention for long prefill: forward only
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention forward: outer loop over query chunks, inner
    online softmax over key/value chunks; the transient is O(q_chunk *
    kv_chunk) per (batch, head)."""
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
    kvh = k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = _split_gqa(q, kvh)
    outs = []
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
    # (nq, B, kv, g, qc, K) -> (B, S, H, K)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(b, s, h, hd)


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      dense_threshold: int = 2048) -> torch.Tensor:
    """Dense attention up to ``dense_threshold`` query positions (or for a
    causal call whose query and key lengths differ), chunked above."""
    if q.shape[1] <= dense_threshold or (causal and q.shape[1] != k.shape[1]):
        return full_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window)


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
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = torch.remainder(pos, cache.shape[1])
    new = new[:, 0].to(cache.dtype)
    if live is not None:
        keep = live.reshape((-1,) + (1,) * (new.ndim - 1))
        new = torch.where(keep, new, cache[rows, slot])
    cache[rows, slot] = new
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
