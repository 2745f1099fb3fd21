"""xLSTM layers [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM
(scalar memory, strictly recurrent with exponential gating).

mLSTM recurrence (per head, head_dim = dh):
    m_t = max(f~_t + m_{t-1}, i~_t)
    i_t = exp(i~_t - m_t),  f_t = exp(f~_t + m_{t-1} - m_t)
    C_t = f_t C_{t-1} + i_t v_t k_t^T          (k scaled by dh^-1/2)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, 1)

Prefill and decode both run the recurrence, a loop over time through
``utils/scan.py`` ``scan`` (the reference's ``lax.scan``). The stabilizer ``m`` keeps both exponentials finite; the
states are float32 whatever the model's dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.types import ModelConfig
from repro_torch.models.init import spec
from repro_torch.utils.scan import scan

_M_INIT = -1e30          # the stabilizer's start: below any gate


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.num_heads
    return d_inner, heads, d_inner // heads


def mlstm_spec(cfg: ModelConfig):
    d = cfg.d_model
    di, h, dh = mlstm_dims(cfg)
    w = cfg.ssm_conv_width
    dt_ = cfg.param_dtype
    return {
        "up_proj": spec((d, 2 * di), ("embed", "ssm_in"), dt_),
        "conv_w": spec((w, di), (None, "ffn"), dt_, scale=0.5),
        "conv_b": spec((di,), ("ffn",), dt_, init="zeros"),
        "wq": spec((di, di), ("ffn", "ssm_qk"), dt_),
        "wk": spec((di, di), ("ffn", "ssm_qk"), dt_),
        "wv": spec((di, di), ("ffn", "ssm_qk"), dt_),
        "w_igate": spec((di, h), ("ffn", "heads"), "float32", scale=0.1),
        "b_igate": spec((h,), ("heads",), "float32", init="zeros"),
        "w_fgate": spec((di, h), ("ffn", "heads"), "float32", scale=0.1),
        "b_fgate": spec((h,), ("heads",), "float32", init="ones"),
        "skip": spec((di,), ("ffn",), dt_, init="ones"),
        "out_norm": spec((di,), ("ffn",), dt_, init="ones"),
        "down_proj": spec((di, d), ("ffn", "embed"), dt_),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, h, dh, dh) float32
    n: torch.Tensor     # (B, h, dh)
    m: torch.Tensor     # (B, h)
    conv: torch.Tensor  # (B, width-1, d_inner)


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> MLSTMState:
    di, h, dh = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        torch.zeros((batch, h, dh, dh), **f32),
        torch.zeros((batch, h, dh), **f32),
        torch.full((batch, h), _M_INIT, **f32),
        torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dtype,
                    device=device),
    )


def _mlstm_cell_scan(q, k, v, ig, fg, state: MLSTMState):
    """q,k,v: (B,L,h,dh) f32; ig,fg: (B,L,h) f32. Returns (y, (C, n, m))."""
    dh = q.shape[-1]
    k = k * dh ** -0.5

    def step(carry, t):
        C, n, m = carry
        qt, kt, vt, it_, ft_ = t
        m_new = torch.maximum(ft_ + m, it_)                     # (B,h)
        i = torch.exp(it_ - m_new)
        f = torch.exp(ft_ + m - m_new)
        C = C * f[..., None, None] + i[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])                # (B,h,dh_v,dh_k)
        n = n * f[..., None] + i[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                          min=1.0)
        return (C, n, m_new), num / den[..., None]

    (C, n, m), y = scan(step, (state.C, state.n, state.m), (q, k, v, ig, fg))
    return y, (C, n, m)


def _conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               conv_state: Optional[torch.Tensor] = None):
    """Causal depthwise conv + silu. x: (B,L,C). Returns (float32 output,
    the last width-1 conv inputs)."""
    width = w.shape[0]
    if conv_state is None:
        pad = F.pad(x, (0, 0, width - 1, 0))
    else:
        pad = torch.cat([conv_state, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i: i + x.shape[1]] * w[i]
    new_state = pad[:, -(width - 1):] if width > 1 else pad[:, :0]
    return F.silu((out + b).float()), new_state


def _headwise_rmsnorm(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm. y: (B,L,h,dh) f32 -> (B,L,h*dh)."""
    ms = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * (ms + 1e-5) ** -0.5
    b, l, h, dh = y.shape
    return y.reshape(b, l, h * dh) * scale.float()


def apply_mlstm(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, L, d). Returns (out, the state after the last step)."""
    di, h, dh = mlstm_dims(cfg)
    b, l, _ = x.shape
    if state is None:
        state = init_mlstm_state(cfg, b, x.dtype, x.device)
    up = torch.matmul(x, params["up_proj"])
    xin, z = up[..., :di], up[..., di:]
    xc, new_conv = _conv_silu(xin, params["conv_w"], params["conv_b"],
                              state.conv)
    xc = xc.to(x.dtype)

    q = torch.matmul(xc, params["wq"]).reshape(b, l, h, dh)
    k = torch.matmul(xc, params["wk"]).reshape(b, l, h, dh)
    v = torch.matmul(xin, params["wv"]).reshape(b, l, h, dh)
    xcf = xc.float()
    ig = torch.matmul(xcf, params["w_igate"]) + params["b_igate"]
    fg = torch.log(torch.sigmoid(torch.matmul(xcf, params["w_fgate"])
                                 + params["b_fgate"]) + 1e-30)
    y, (C, n, m) = _mlstm_cell_scan(q.float(), k.float(), v.float(), ig, fg,
                                    state)
    y = _headwise_rmsnorm(y, params["out_norm"])                # (B,L,di) f32
    y = y + xcf * params["skip"].float()
    y = y * F.silu(z.float())
    out = torch.matmul(y.to(x.dtype), params["down_proj"])
    return out, MLSTMState(C, n, m, new_conv)


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


def slstm_spec(cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    w = cfg.ssm_conv_width
    dt_ = cfg.param_dtype
    ffn = int(round(4 / 3 * d / 64)) * 64 or 64
    p = {
        "conv_w": spec((w, d), (None, "embed"), dt_, scale=0.5),
        "conv_b": spec((d,), ("embed",), dt_, init="zeros"),
        "out_norm": spec((d,), ("embed",), dt_, init="ones"),
        "ffn_gate": spec((d, ffn), ("embed", "ffn"), dt_),
        "ffn_up": spec((d, ffn), ("embed", "ffn"), dt_),
        "ffn_down": spec((ffn, d), ("ffn", "embed"), dt_),
    }
    for gate in _GATES:
        p[f"w_{gate}"] = spec((d, d), ("embed", "ssm_qk"), dt_)
        p[f"r_{gate}"] = spec((h, dh, dh), ("heads", "head_dim", None), dt_,
                              scale=0.5)
        p[f"b_{gate}"] = spec(
            (d,), ("ssm_qk",), "float32",
            init="ones" if gate == "f" else "zeros",
        )
    return p


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, h, dh) float32
    n: torch.Tensor
    hid: torch.Tensor
    m: torch.Tensor     # (B, h, dh)
    conv: torch.Tensor  # (B, width-1, d)


def init_slstm_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> SLSTMState:
    h = cfg.num_heads
    dh = cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(
        torch.zeros((batch, h, dh), **f32),
        torch.zeros((batch, h, dh), **f32),
        torch.zeros((batch, h, dh), **f32),
        torch.full((batch, h, dh), _M_INIT, **f32),
        torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_model),
                    dtype=dtype, device=device),
    )


def apply_slstm(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """Strictly sequential sLSTM, then its GeGLU feed-forward. x: (B, L, d)."""
    b, l, d = x.shape
    h = cfg.num_heads
    dh = d // h
    if state is None:
        state = init_slstm_state(cfg, b, x.dtype, x.device)

    xc, new_conv = _conv_silu(x, params["conv_w"], params["conv_b"],
                              state.conv)
    xc = xc.to(x.dtype)

    def head(v):
        return v.reshape(*v.shape[:-1], h, dh).float()

    pre = {g: head(torch.matmul(xc if g in ("i", "f") else x,
                                params[f"w_{g}"])
                   + params[f"b_{g}"].to(x.dtype))
           for g in _GATES}
    R = tuple(params[f"r_{g}"].float() for g in _GATES)

    def step(carry, t, rz, ri, rf, ro):
        c, n, hid, m = carry
        pz, pi, pf, po = t

        def rec(r):
            return torch.einsum("bhk,hkv->bhv", hid, r)

        zt = torch.tanh(pz + rec(rz))
        it_ = pi + rec(ri)
        ft_ = pf + rec(rf)
        ot = torch.sigmoid(po + rec(ro))
        logf = torch.log(torch.sigmoid(ft_) + 1e-30)
        m_new = torch.maximum(logf + m, it_)
        i = torch.exp(it_ - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * zt
        n = f * n + i
        hid = ot * c / torch.clamp(n, min=1e-6)
        return (c, n, hid, m_new), hid

    (c, n, hid, m), y = scan(step, (state.c, state.n, state.hid, state.m),
                             tuple(pre[g] for g in _GATES), consts=R)
    ms = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = (y * (ms + 1e-5) ** -0.5).reshape(b, l, d)
    y = (y * params["out_norm"].float()).to(x.dtype)

    # Post-FFN (GeGLU 4/3, per the xLSTM block design; jax.nn.gelu's
    # default is the tanh approximation).
    gate = torch.matmul(y, params["ffn_gate"])
    up = torch.matmul(y, params["ffn_up"])
    hred = F.gelu(gate.float(), approximate="tanh").to(x.dtype) * up
    out = torch.matmul(hred, params["ffn_down"])
    return out, SLSTMState(c, n, hid, m, new_conv)
