"""Mamba2 (SSD) layer [arXiv:2405.21060], used by zamba2 [arXiv:2411.15242].

Prefill uses the chunk-wise SSD algorithm (an intra-chunk quadratic,
attention-like term plus an inter-chunk recurrent state carried by a loop
over chunks) when the length is longer than one chunk, and the plain
recurrence otherwise. A length that is not a multiple of the chunk pads
its last chunk with ``dt = 0`` (and zero inputs): the state passes a pad
unchanged, and the pads' outputs are dropped. Decode is the recurrence
``S <- S*exp(dt*A) + dt*B x^T; y = C.S + D*x``. Each prefill is a span
``ssm.prefill`` (``rows``, ``tokens``, ``chunks``: 0 on the recurrence)
and counts in :data:`PREFILLS` by route.

State layout: ``S``: (batch, heads, state, head_dim) float32; the conv
state keeps the last (width-1) raw conv inputs in the model dtype.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.types import ModelConfig, mup
from repro_torch.models.init import spec
from repro_torch.utils.scan import scan
from repro_torch.utils.trace import span

MAMBA_HEAD_DIM = 64
SSD_CHUNK = 256
# Prefills by route: "chunked" (the chunked SSD) or "recurrence".
PREFILLS: "collections.Counter[str]" = collections.Counter()


class MambaDims(NamedTuple):
    d_inner: int
    heads: int
    head_dim: int
    state: int
    conv_width: int
    conv_channels: int


def mamba_dims(cfg: ModelConfig) -> MambaDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    head_dim = MAMBA_HEAD_DIM
    heads = d_inner // head_dim
    state = cfg.ssm_state_dim
    return MambaDims(
        d_inner, heads, head_dim, state, cfg.ssm_conv_width, d_inner + 2 * state
    )


def mamba2_spec(cfg: ModelConfig):
    d = cfg.d_model
    dims = mamba_dims(cfg)
    di, h, n, w = dims.d_inner, dims.heads, dims.state, dims.conv_width
    dt_, ssm_dt = cfg.param_dtype, mup(cfg, "ssm_param_dtype")
    return {
        # in_proj -> [z(di), x(di), B(n), C(n), dt(h)]
        "in_proj": spec((d, 2 * di + 2 * n + h), ("embed", "ssm_in"), dt_),
        "conv_w": spec((w, dims.conv_channels), (None, "ssm_in"), dt_, scale=0.5),
        "conv_b": spec((dims.conv_channels,), ("ssm_in",), dt_, init="zeros"),
        "A_log": spec((h,), ("heads",), ssm_dt, init="zeros"),
        "D": spec((h,), ("heads",), ssm_dt, init="ones"),
        "dt_bias": spec((h,), ("heads",), ssm_dt, init="zeros"),
        "norm_scale": spec((di,), ("ffn",), dt_, init="ones"),
        "out_proj": spec((di, d), ("ffn", "embed"), dt_),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q) with [i, j] = sum_{j < k <= i} a_k (i>=j),
    exactly -inf above the diagonal (so its exp is exactly 0)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p) f32; dt: (b, l, h) f32, post-softplus; A: (h,) f32,
    negative; B, C: (b, l, n). Returns (y (b, l, h, p), final state
    (b, h, n, p))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    a = dtc * A                                    # (b,nc,q,h)
    a_cs = torch.cumsum(a, dim=2)

    # Intra-chunk (quadratic) term. The weights (C_q . B_s) L_qs dt_s are
    # formed first, so the product with x is one batched matmul: a path
    # einsum picks for the four operands at once can hold a (b, nc, q, s,
    # h, p) intermediate, 30 GB at 7,168 positions of 64 heads of 64.
    L = torch.exp(_segsum(a.permute(0, 1, 3, 2)))  # (b,nc,h,q,s)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    w = scores[:, :, None] * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", w, xc)

    # Per-chunk end states.
    decay_to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)       # (b,nc,q,h)
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, decay_to_end * dtc,
                          xc)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])                # (b,nc,h)

    S = (init_state if init_state is not None
         else x.new_zeros((b, h, n, p), dtype=torch.float32))
    prev = []
    for c in range(nc):                       # emit each chunk's pre-state
        prev.append(S)
        S = S * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_t = torch.stack(prev, dim=1)                         # (b,nc,h,n,p)

    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, prev_t,
                         torch.exp(a_cs))
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, S


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step recurrence (the decode's, and the oracle of
    :func:`ssd_chunked`), through ``utils/scan.py`` ``scan``."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    S = (init_state if init_state is not None
         else x.new_zeros((b, h, n, p), dtype=torch.float32))

    def step(S, t, A):
        xt, dtt, Bt, Ct = t
        decay = torch.exp(dtt * A)                            # (b,h)
        dBx = torch.einsum("bn,bh,bhp->bhnp", Bt, dtt, xt)
        S = S * decay[..., None, None] + dBx
        return S, torch.einsum("bn,bhnp->bhp", Ct, S)

    S, y = scan(step, S, (x, dt, B, C), consts=(A,))
    return y, S


class MambaState(NamedTuple):
    ssm: torch.Tensor   # (B, heads, state, head_dim) float32
    conv: torch.Tensor  # (B, width-1, conv_channels)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> MambaState:
    dims = mamba_dims(cfg)
    return MambaState(
        torch.zeros((batch, dims.heads, dims.state, dims.head_dim),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, dims.conv_width - 1, dims.conv_channels),
                    dtype=dtype, device=device),
    )


def _causal_depthwise_conv(xbc: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """xbc: (B, L, C); w: (W, C) depthwise kernel; causal."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i: i + xbc.shape[1]] * w[i]
    return out + b


def _split_in_proj(proj: torch.Tensor, dims: MambaDims):
    di = dims.d_inner
    z = proj[..., :di]
    xbc = proj[..., di: di + dims.conv_channels]
    dt_raw = proj[..., di + dims.conv_channels:]
    return z, xbc, dt_raw


def _ssm_inputs(params, xbc: torch.Tensor, dt_raw: torch.Tensor,
                dims: MambaDims):
    """(x per head, B, C, dt, A) from the activated conv output."""
    xin = xbc[..., : dims.d_inner]
    Bm = xbc[..., dims.d_inner: dims.d_inner + dims.state]
    Cm = xbc[..., dims.d_inner + dims.state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xin.reshape(*xin.shape[:2], dims.heads, dims.head_dim)
    return xh, Bm, Cm, dt, A


def _gated_out(params, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """Gated RMSNorm (mamba2's norm before out_proj), then out_proj."""
    g = F.silu(z.float())
    yn = y * g
    ms = torch.mean(torch.square(yn), dim=-1, keepdim=True)
    yn = yn * (ms + 1e-5) ** -0.5 * params["norm_scale"].float()
    return torch.matmul(yn.to(dtype), params["out_proj"])


def ssd_chunks(length: int, chunk: int = SSD_CHUNK) -> int:
    """Chunks a prefill of ``length`` takes, its last one padded: 0 (the
    recurrence) up to one chunk."""
    return -(-length // chunk) if length > chunk else 0


def ssd_padded(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunked` over any length: the last chunk padded with
    ``dt = 0`` and zero inputs, so each pad decays the state by
    ``exp(0) = 1`` and adds nothing; the pads' outputs are dropped."""
    length = x.shape[1]
    pad = -length % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C))
    y, S = ssd_chunked(x, dt, A, B, C, chunk)
    return y[:, :length], S


def mamba2_seq(params, x: torch.Tensor, cfg: ModelConfig,
               chunk: int = SSD_CHUNK) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence forward with its final recurrent state. x: (B, L, d).
    The SSD is chunked when L is longer than ``chunk`` (the last chunk
    padded, :func:`ssd_padded`), sequential otherwise. The conv state is
    re-derived from the last width-1 raw conv inputs, left-padded with
    zeros when L is shorter."""
    dims = mamba_dims(cfg)
    b, length = x.shape[:2]
    chunks = ssd_chunks(length, chunk)
    PREFILLS["chunked" if chunks else "recurrence"] += 1
    with span("ssm.prefill", rows=b, tokens=b * length, chunks=chunks):
        proj = torch.matmul(x, params["in_proj"])
        z, xbc_raw, dt_raw = _split_in_proj(proj, dims)
        conv_tail = xbc_raw[:, -(dims.conv_width - 1):]
        if length < dims.conv_width - 1:
            conv_tail = F.pad(conv_tail,
                              (0, 0, dims.conv_width - 1 - length, 0))
        xbc = F.silu(_causal_depthwise_conv(
            xbc_raw, params["conv_w"], params["conv_b"]).float())
        xh, Bm, Cm, dt, A = _ssm_inputs(params, xbc, dt_raw, dims)
        if chunks:
            y, S = ssd_padded(xh, dt, A, Bm, Cm, chunk)
        else:
            y, S = ssd_sequential(xh, dt, A, Bm, Cm)
        y = y + params["D"][None, None, :, None] * xh
        y = y.reshape(b, length, dims.d_inner)
        return _gated_out(params, y, z, x.dtype), MambaState(S, conv_tail)


def apply_mamba2(params, x: torch.Tensor, cfg: ModelConfig,
                 chunk: int = SSD_CHUNK) -> torch.Tensor:
    """Full-sequence (prefill) forward. x: (B, L, d_model)."""
    return mamba2_seq(params, x, cfg, chunk)[0]


def decode_mamba2(params, x: torch.Tensor, state: MambaState,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, MambaState]:
    """One-token decode. x: (B, 1, d_model)."""
    dims = mamba_dims(cfg)
    proj = torch.matmul(x, params["in_proj"])
    z, xbc_new, dt_raw = _split_in_proj(proj, dims)

    # Causal conv via the rolling raw-input state.
    window = torch.cat([state.conv, xbc_new], dim=1)          # (B, W, C)
    conv_out = (torch.einsum("bwc,wc->bc", window.float(),
                             params["conv_w"].float())
                + params["conv_b"].float())[:, None, :]
    xbc = F.silu(conv_out)
    new_conv_state = window[:, 1:]

    xh, Bm, Cm, dt, A = _ssm_inputs(params, xbc, dt_raw, dims)
    xh = xh[:, 0]                                             # (B,h,p)
    decay = torch.exp(dt[:, 0] * A)                           # (B,h)
    dBx = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0], dt[:, 0], xh)
    S = state.ssm * decay[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], S)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(x.shape[0], 1, dims.d_inner)
    return _gated_out(params, y, z, x.dtype), MambaState(S, new_conv_state)
