"""Block-level composition of the dense decoder.

Every architecture is a sequence of *segments*; a segment is a contiguous
run of identical blocks whose parameters are stacked along a leading layer
axis (the reference's layout, so a reference parameter tree bridges in
as it is). The port runs block kind ``'d'``, the dense decoder block
(attention + SwiGLU) of the llama family; the other kinds of the
reference raise.

Each kind provides ``block_spec`` (ParamSpec tree), ``block_apply_seq``
(full sequence; returns (x, cache_entry)) and ``block_apply_decode`` (one
token a row; returns (x, cache_entry), the entry updated in place).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.types import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.mlp import apply_swiglu, swiglu_spec
from repro_torch.models.layers.norms import apply_norm, norm_spec

# The reference's other block kinds, none of them ported yet.
_UNPORTED = {
    "e": "the MoE decoder block (moe family)",
    "m": "the Mamba2 block (ssm / hybrid families)",
    "l": "the mLSTM block (ssm family)",
    "s": "the sLSTM block (ssm family)",
    "A": "the shared attention block (hybrid family)",
    "E": "the encoder block (audio family)",
    "c": "the cross-attention decoder block (audio family)",
}


def _check_kind(kind: str) -> None:
    if kind in _UNPORTED:
        raise NotImplementedError(
            f"repro_torch: block kind {kind!r}, {_UNPORTED[kind]}, is not "
            "ported yet (ROADMAP.md queue 1, item 4: the LM stack's other "
            "families)")
    if kind != "d":
        raise ValueError(f"unknown block kind {kind!r}")


class SeqContext(NamedTuple):
    """Everything a block needs for a full-sequence pass."""

    positions: torch.Tensor                   # (B, S) int
    window: int                               # 0 = full attention
    cache_len: int                            # 0 = don't build decode caches


class DecodeContext(NamedTuple):
    pos: torch.Tensor                         # (B,) index of each new token
    window: int
    live: Optional[torch.Tensor] = None       # (B,) bool rows that advance


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def block_spec(kind: str, cfg: ModelConfig):
    _check_kind(kind)
    d, dt_ = cfg.d_model, cfg.param_dtype
    return {
        "ln1": norm_spec(cfg.norm_kind, d, dt_),
        "attn": attn_lib.attention_spec(cfg),
        "ln2": norm_spec(cfg.norm_kind, d, dt_),
        "mlp": swiglu_spec(d, cfg.d_ff, dt_),
    }


# ---------------------------------------------------------------------------
# Cache helpers
# ---------------------------------------------------------------------------


def _ring_place(arr: torch.Tensor, seq_len: int,
                cache_len: int) -> torch.Tensor:
    """Place the last ``cache_len`` steps of (B,S,...) into ring-buffer order
    (slot of position p is p % cache_len)."""
    if seq_len <= cache_len:
        pad = arr.new_zeros((arr.shape[0], cache_len - seq_len)
                            + tuple(arr.shape[2:]))
        return torch.cat([arr, pad], dim=1)
    tail = arr[:, -cache_len:]
    return torch.roll(tail, shifts=seq_len % cache_len, dims=1)


def _kv_cache_entry(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                    device=None):
    kv, hd = cfg.num_kv_heads, cfg.head_dim_

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.kv_cache_bits == 8:
        return {"k": zeros((batch, cache_len, kv, hd), torch.int8),
                "ks": zeros((batch, cache_len, kv), torch.float32),
                "v": zeros((batch, cache_len, kv, hd), torch.int8),
                "vs": zeros((batch, cache_len, kv), torch.float32)}
    return {"k": zeros((batch, cache_len, kv, hd), dtype),
            "v": zeros((batch, cache_len, kv, hd), dtype)}


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     dtype, device=None):
    """Zero cache entry for ONE block of this kind (unstacked)."""
    _check_kind(kind)
    return _kv_cache_entry(cfg, batch, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# Full-sequence application
# ---------------------------------------------------------------------------


def block_apply_seq(kind: str, params, x: torch.Tensor, ctx: SeqContext,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """Returns (x_new, cache_entry_or_None)."""
    _check_kind(kind)
    s = x.shape[1]
    h = apply_norm(cfg.norm_kind, params["ln1"], x)
    q, k, v = attn_lib.project_qkv(params["attn"], h, ctx.positions, cfg)
    out = attn_lib.prefill_attention(q, k, v, causal=True, window=ctx.window)
    x = x + attn_lib.attn_output(params["attn"], out)
    h2 = apply_norm(cfg.norm_kind, params["ln2"], x)
    x = x + apply_swiglu(params["mlp"], h2)
    cache = None
    if ctx.cache_len:
        cache = _build_kv_cache(k, v, s, ctx.cache_len, cfg)
    return x, cache


def _build_kv_cache(k, v, s, cache_len, cfg: ModelConfig):
    """Ring-ordered KV cache from prefill keys/values, optionally
    JALAD-quantized to int8 (cfg.kv_cache_bits == 8)."""
    kc = _ring_place(k, s, cache_len)
    vc = _ring_place(v, s, cache_len)
    if cfg.kv_cache_bits == 8:
        qk, ks = attn_lib.quantize_kv_row(kc)
        qv, vs = attn_lib.quantize_kv_row(vc)
        return {"k": qk, "ks": ks, "v": qv, "vs": vs}
    return {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------


def block_apply_decode(kind: str, params, x: torch.Tensor, cache,
                       ctx: DecodeContext, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Any]:
    """x: (B, 1, d). Returns (x_new, cache), the cache updated in place at
    each live row's position."""
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, params["ln1"], x)
    q, k, v = attn_lib.project_qkv(params["attn"], h, ctx.pos[:, None], cfg)
    if cfg.kv_cache_bits == 8:
        qk, ks_new = attn_lib.quantize_kv_row(k)
        qv, vs_new = attn_lib.quantize_kv_row(v)
        k_c, v_c = attn_lib.cache_update(cache["k"], cache["v"], qk, qv,
                                         ctx.pos, ctx.live)
        ks_c = attn_lib.scale_update(cache["ks"], ks_new, ctx.pos, ctx.live)
        vs_c = attn_lib.scale_update(cache["vs"], vs_new, ctx.pos, ctx.live)
        k_use = attn_lib.dequantize_kv(k_c, ks_c, q.dtype)
        v_use = attn_lib.dequantize_kv(v_c, vs_c, q.dtype)
    else:
        k_use, v_use = attn_lib.cache_update(cache["k"], cache["v"], k, v,
                                             ctx.pos, ctx.live)
    out = attn_lib.decode_attention(q, k_use, v_use, ctx.pos + 1)
    x = x + attn_lib.attn_output(params["attn"], out)
    h2 = apply_norm(cfg.norm_kind, params["ln2"], x)
    return x + apply_swiglu(params["mlp"], h2), cache
