"""Block-level composition.

Every architecture is a sequence of *segments*; a segment is a contiguous
run of identical blocks whose parameters are stacked along a leading layer
axis (the reference's layout, so a reference parameter tree bridges in
as it is). Block kinds the port runs:

  'd'  dense decoder block   (attn + SwiGLU)           — llama family
  'e'  MoE decoder block     (attn + top-k experts)    — llama4 / grok
  'm'  Mamba2 block                                    — zamba2
  'M'  Mamba2 block with its own normed SwiGLU MLP      — granite-4.0-h
  'l'  mLSTM block                                     — xlstm
  's'  sLSTM block                                     — xlstm
  'A'  shared attention block (zamba2; one parameter set, many invocations)
  'E'  encoder block         (bidirectional attn + GELU MLP) — seamless
  'c'  decoder-with-cross-attention block              — seamless

Each kind provides ``block_spec`` (ParamSpec tree), ``block_apply_seq``
(full sequence; returns (x, aux_loss, cache_entry): the MoE block's
load-balance loss, None for every other kind) and ``block_apply_decode`` (one
token a row; returns (x, cache_entry), the entry updated in place: an
attention block writes each live row's KV at its position, a recurrent
block overwrites each live row's state and leaves the other rows' as they
were).

Both residual branches of a block are scaled by its config's
``residual_multiplier`` (``config.types.mup``) where it is not 1 (a muP
configuration's); at 1 the sum is the plain ``x + y`` it always was. A
Mamba2 decode (the mixer and its state's write-back) is a span
``ssm.decode`` (``rows``, ``tokens``, ``chunks``: 0).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.types import ModelConfig, mup
from repro_torch.kernels.attention import ops as kv8_ops
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import mamba2 as mamba_lib
from repro_torch.models.layers import xlstm as xlstm_lib
from repro_torch.models.layers.mlp import (
    apply_gelu_mlp,
    apply_swiglu,
    gelu_mlp_spec,
    swiglu_spec,
)
from repro_torch.models.layers.moe import (
    Routing,
    load_balance_loss,
    moe_forward,
    moe_spec,
)
from repro_torch.models.layers.norms import apply_norm, norm_spec
from repro_torch.sharding.activation import like_layout, on_batch_shard
from repro_torch.utils.trace import span

_ATTN = ("d", "e", "A")     # attention, then SwiGLU ('e': the experts);
                            # 'A' shares its weights
_ENCDEC = ("E", "c")        # layernorm blocks with a GELU MLP (seamless)
_RECURRENT = {"m": "mamba", "M": "mamba", "l": "mlstm",
              "s": "slstm"}     # kind -> params key; 'M' adds an MLP


def _check_kind(kind: str) -> None:
    if kind not in _ATTN and kind not in _ENCDEC and kind not in _RECURRENT:
        raise ValueError(f"unknown block kind {kind!r}")


class SeqContext(NamedTuple):
    """Everything a block needs for a full-sequence pass."""

    positions: torch.Tensor                   # (B, S) int
    window: int                               # 0 = full attention
    cache_len: int                            # 0 = don't build decode caches
    positions_3d: Optional[torch.Tensor] = None   # (B, S, 3) M-RoPE ids
    enc_out: Optional[torch.Tensor] = None    # encoder output for 'c'
    want_aux: bool = False                    # MoE load-balance loss


class DecodeContext(NamedTuple):
    pos: torch.Tensor                         # (B,) index of each new token
    window: int
    live: Optional[torch.Tensor] = None       # (B,) bool rows that advance
    positions_3d: Optional[torch.Tensor] = None   # (B, 1, 3) M-RoPE ids


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def block_spec(kind: str, cfg: ModelConfig):
    _check_kind(kind)
    d, dt_ = cfg.d_model, cfg.param_dtype
    if kind == "m":
        return {"ln": norm_spec(cfg.norm_kind, d, dt_),
                "mamba": mamba_lib.mamba2_spec(cfg)}
    if kind == "M":
        return {"ln": norm_spec(cfg.norm_kind, d, dt_),
                "mamba": mamba_lib.mamba2_spec(cfg),
                "ln2": norm_spec(cfg.norm_kind, d, dt_),
                "mlp": swiglu_spec(d, cfg.d_ff, dt_)}
    if kind == "l":
        return {"ln": norm_spec(cfg.norm_kind, d, dt_),
                "mlstm": xlstm_lib.mlstm_spec(cfg)}
    if kind == "s":
        return {"ln": norm_spec(cfg.norm_kind, d, dt_),
                "slstm": xlstm_lib.slstm_spec(cfg)}
    if kind == "E":
        return {
            "ln1": norm_spec("layernorm", d, dt_),
            "attn": attn_lib.attention_spec(cfg),
            "ln2": norm_spec("layernorm", d, dt_),
            "mlp": gelu_mlp_spec(d, cfg.d_ff, dt_),
        }
    if kind == "c":
        return {
            "ln1": norm_spec("layernorm", d, dt_),
            "attn": attn_lib.attention_spec(cfg),
            "ln_x": norm_spec("layernorm", d, dt_),
            "xattn": attn_lib.attention_spec(cfg, cross=True),
            "ln2": norm_spec("layernorm", d, dt_),
            "mlp": gelu_mlp_spec(d, cfg.d_ff, dt_),
        }
    return {
        "ln1": norm_spec(cfg.norm_kind, d, dt_),
        "attn": attn_lib.attention_spec(cfg),
        "ln2": norm_spec(cfg.norm_kind, d, dt_),
        "mlp": moe_spec(cfg) if kind == "e" else swiglu_spec(d, cfg.d_ff, dt_),
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
                     dtype, device=None, enc_len: int = 0):
    """Zero cache entry for ONE block of this kind (unstacked). An ``'E'``
    block has none; a ``'c'`` block adds the encoder's cross-attention
    keys and values (``xk``/``xv``, ``enc_len`` rows in the activation
    dtype, also when the self-attention KV is int8)."""
    _check_kind(kind)
    if kind == "E":
        return {}
    if kind == "c":
        entry = _kv_cache_entry(cfg, batch, cache_len, dtype, device)
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim_)
        entry.update(xk=torch.zeros(shape, dtype=dtype, device=device),
                     xv=torch.zeros(shape, dtype=dtype, device=device))
        return entry
    if kind in ("m", "M"):
        return mamba_lib.init_mamba_state(cfg, batch, dtype,
                                          device)._asdict()
    if kind == "l":
        return xlstm_lib.init_mlstm_state(cfg, batch, dtype,
                                          device)._asdict()
    if kind == "s":
        return xlstm_lib.init_slstm_state(cfg, batch, dtype,
                                          device)._asdict()
    return _kv_cache_entry(cfg, batch, cache_len, dtype, device)


def block_cache_axes(kind: str, cfg: ModelConfig = None):
    """Logical axis names for each cache entry of ``init_block_cache``
    (same tree structure; tuples align with array dims). Consumed by the
    sharding resolver for the dry run's inputs."""
    kv4 = ("batch", "kv_seq", "kv_heads", "head_dim")
    kv3 = ("batch", "kv_seq", "kv_heads")
    q8 = cfg is not None and cfg.kv_cache_bits == 8
    if kind in ("d", "e", "A"):
        if q8:
            return {"k": kv4, "ks": kv3, "v": kv4, "vs": kv3}
        return {"k": kv4, "v": kv4}
    if kind in ("m", "M"):
        return {
            "ssm": ("batch", "heads", "ssm_state", "head_dim"),
            "conv": ("batch", None, "conv_out"),
        }
    if kind == "l":
        return {
            "C": ("batch", "heads", "head_dim", None),
            "n": ("batch", "heads", "head_dim"),
            "m": ("batch", "heads"),
            "conv": ("batch", None, "ssm_in"),
        }
    if kind == "s":
        hd3 = ("batch", "heads", "head_dim")
        return {"c": hd3, "n": hd3, "hid": hd3, "m": hd3,
                "conv": ("batch", None, None)}
    if kind == "c":
        enc4 = ("batch", "enc_seq", "kv_heads", "head_dim")
        if q8:
            return {"k": kv4, "ks": kv3, "v": kv4, "vs": kv3,
                    "xk": enc4, "xv": enc4}
        return {"k": kv4, "v": kv4, "xk": enc4, "xv": enc4}
    if kind == "E":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Full-sequence application
# ---------------------------------------------------------------------------


def block_apply_seq(kind: str, params, x: torch.Tensor, ctx: SeqContext,
                    cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Any]:
    """Returns (x_new, aux_loss, cache_entry_or_None): ``aux_loss`` is an
    ``'e'`` block's float32 load-balance loss with ``ctx.want_aux``, None
    without it and for any other kind (the reference's zero)."""
    _check_kind(kind)
    if kind in _RECURRENT:
        h = apply_norm(cfg.norm_kind, params["ln"], x)
        y, state = _recurrent_seq(kind, params[_RECURRENT[kind]], h, cfg)
        x = _mixer_mlp(kind, params, _residual(x, y, cfg), cfg)
        return x, None, state._asdict() if ctx.cache_len else None
    s = x.shape[1]
    if kind == "E":
        # Bidirectional, no window, no cache; RoPE only if the config has
        # one (seamless: none).
        h = apply_norm("layernorm", params["ln1"], x)
        q, k, v = attn_lib.project_qkv(params["attn"], h, ctx.positions, cfg,
                                       positions_3d=ctx.positions_3d)
        out = attn_lib.prefill_attention(q, k, v, causal=False)
        x = x + attn_lib.attn_output(params["attn"], out)
        return x + _mlp(kind, params, x, cfg)[0], None, None
    h = apply_norm(_norm_kind(kind, cfg), params["ln1"], x)
    q, k, v = attn_lib.project_qkv(
        params["attn"], h, ctx.positions, cfg,
        positions_3d=None if kind == "c" else ctx.positions_3d)
    out = attn_lib.prefill_attention(q, k, v, causal=True, window=ctx.window)
    x = _residual(x, attn_lib.attn_output(params["attn"], out), cfg)
    if kind == "c":
        hx = apply_norm("layernorm", params["ln_x"], x)
        xk, xv = attn_lib.cross_attention_kv(params["xattn"], ctx.enc_out)
        x = x + attn_lib.cross_attention(params["xattn"], hx, xk, xv)
    y, routing = _mlp(kind, params, x, cfg)
    x = _residual(x, y, cfg)
    aux = (load_balance_loss(routing)
           if ctx.want_aux and routing is not None else None)
    cache = None
    if ctx.cache_len:
        cache = _build_kv_cache(k, v, s, ctx.cache_len, cfg)
        if kind == "c":
            cache.update(xk=xk, xv=xv)
    return x, aux, cache


def _residual(x: torch.Tensor, y: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """``x + r * y`` with ``r`` the residual multiplier; ``x + y`` at 1."""
    r = mup(cfg, "residual_multiplier")
    return x + y if r == 1.0 else x + y * r


def _mixer_mlp(kind: str, params, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """After a recurrent mixer's residual: an ``'M'`` block's own normed
    SwiGLU MLP and its residual; any other kind is done."""
    if kind != "M":
        return x
    return _residual(x, _mlp(kind, params, x, cfg)[0], cfg)


def _norm_kind(kind: str, cfg: ModelConfig) -> str:
    return "layernorm" if kind in _ENCDEC else cfg.norm_kind


def _mlp(kind: str, params, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[Routing]]:
    """``ln2``, then the feed-forward of an attention block: the experts of
    an ``'e'`` block and their routing, the GELU MLP of an ``'E'`` /
    ``'c'`` block, SwiGLU otherwise (no routing: None)."""
    h2 = apply_norm(_norm_kind(kind, cfg), params["ln2"], x)
    if kind == "e":
        # The dispatch's buffer views and index copies have no DTensor
        # rule that keeps a sharded buffer: on a mesh the experts run on
        # each rank's batch shard (capacity is per row and group, so a
        # shard routes as the whole batch does), weights gathered at use.
        return on_batch_shard(lambda p, h: moe_forward(p, h, cfg),
                              params["mlp"], h2)
    if kind in _ENCDEC:
        return apply_gelu_mlp(params["mlp"], h2), None
    return apply_swiglu(params["mlp"], h2), None


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


def _recurrent_seq(kind: str, params, h: torch.Tensor, cfg: ModelConfig):
    """A recurrent layer over a sequence: (output, final state). Mamba2's
    is the reference's ``_mamba_seq_with_state`` (chunked SSD on a length
    of whole chunks past one, sequential otherwise). On a mesh it runs on
    each rank's batch shard, weights gathered at use: DTensor refuses to
    unflatten a head dim split wider than the heads (``aten.view``)."""
    fn = {"m": mamba_lib.mamba2_seq, "M": mamba_lib.mamba2_seq,
          "l": xlstm_lib.apply_mlstm, "s": xlstm_lib.apply_slstm}[kind]
    return on_batch_shard(lambda p, x: fn(p, x, cfg), params, h)


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------


def block_apply_decode(kind: str, params, x: torch.Tensor, cache,
                       ctx: DecodeContext, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Any]:
    """x: (B, 1, d). Returns (x_new, cache), the cache updated in place at
    each live row's position (a recurrent state: each live row's)."""
    _check_kind(kind)
    if kind in _RECURRENT:
        return _recurrent_decode(kind, params, x, cache, ctx, cfg)
    if kind == "E":
        raise ValueError("an encoder block runs over the whole source, "
                         "never one decode token")
    h = apply_norm(_norm_kind(kind, cfg), params["ln1"], x)
    q, k, v = attn_lib.project_qkv(params["attn"], h, ctx.pos[:, None], cfg,
                                   positions_3d=ctx.positions_3d)
    if cfg.kv_cache_bits == 8:
        # Plain tensors take the kernel wrapper (the plain version on the
        # CPU); sharded, meta or fake ones the plain composition.
        decode = (kv8_ops.kv8_decode
                  if _plain_tensor(q) and _plain_tensor(cache["k"])
                  else kv8_ops.kv8_decode_plain)
        out = decode(q, k, v, cache, ctx.pos, ctx.live)
    else:
        k_use, v_use = attn_lib.cache_update(cache["k"], cache["v"], k, v,
                                             ctx.pos, ctx.live)
        out = attn_lib.decode_attention(q, k_use, v_use, ctx.pos + 1)
    x = _residual(x, attn_lib.attn_output(params["attn"], out), cfg)
    if kind == "c":
        hx = apply_norm("layernorm", params["ln_x"], x)
        x = x + attn_lib.cross_attention(params["xattn"], hx, cache["xk"],
                                         cache["xv"])
    return _residual(x, _mlp(kind, params, x, cfg)[0], cfg), cache


def _plain_tensor(t: torch.Tensor) -> bool:
    """A tensor of the CPU or the card itself: no DTensor, no fake tensor
    (both subclasses), no meta tensor."""
    return type(t) is torch.Tensor and t.device.type in ("cpu", "cuda")


def _recurrent_decode(kind: str, params, x: torch.Tensor, cache,
                      ctx: DecodeContext, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Any]:
    """One token through a recurrent block. A recurrent state has no
    position to mask by, so rows whose ``live`` flag is off keep every
    leaf (the conv window and ``m`` included) exactly as it was."""
    h = apply_norm(cfg.norm_kind, params["ln"], x)
    if kind in ("m", "M"):
        def step(p, hx, st):
            return mamba_lib.decode_mamba2(p, hx, st, cfg)
        state = mamba_lib.MambaState(**cache)
        sp = span("ssm.decode", rows=x.shape[0], tokens=x.shape[0],
                  chunks=0)
    else:
        apply = xlstm_lib.apply_mlstm if kind == "l" else \
            xlstm_lib.apply_slstm
        state = (xlstm_lib.MLSTMState if kind == "l" else
                 xlstm_lib.SLSTMState)(**cache)

        def step(p, hx, st):
            return apply(p, hx, cfg, st)
        sp = contextlib.nullcontext()
    with sp:
        # On a mesh: each rank's batch shard, as in _recurrent_seq.
        y, state = on_batch_shard(step, params[_RECURRENT[kind]], h, state)
        for k, new in state._asdict().items():
            buf = cache[k]
            if ctx.live is not None:
                keep = ctx.live.reshape((-1,) + (1,) * (new.ndim - 1))
                new = torch.where(keep, new, buf)
            buf.copy_(like_layout(new, buf))
    return _mixer_mlp(kind, params, _residual(x, y, cfg), cfg), cache
