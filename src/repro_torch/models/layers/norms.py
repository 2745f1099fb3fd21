"""Normalization layers: RMSNorm, LayerNorm, and OLMo's non-parametric LN.

The arithmetic is the reference's, op for op, in float32: ``(ms + eps) **
-0.5`` and the population variance as the mean of squared deviations
(``jnp.var``, ddof 0), not ``torch.var``'s one-pass algorithm.
"""
from __future__ import annotations

import torch

from repro_torch.models.init import spec


def rmsnorm_spec(d: int, dtype: str):
    return {"scale": spec((d,), ("embed",), dtype, init="ones")}


def layernorm_spec(d: int, dtype: str):
    return {
        "scale": spec((d,), ("embed",), dtype, init="ones"),
        "bias": spec((d,), ("embed",), dtype, init="zeros"),
    }


def norm_spec(kind: str, d: int, dtype: str):
    if kind == "rmsnorm":
        return rmsnorm_spec(d, dtype)
    if kind == "layernorm":
        return layernorm_spec(d, dtype)
    if kind == "nonparametric":
        return {}  # OLMo: LN without learnable scale/bias [arXiv:2402.00838]
    raise ValueError(kind)


def apply_norm(kind: str, params, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * (ms + eps) ** -0.5
        return (y * params["scale"].float()).to(x.dtype)
    if kind in ("layernorm", "nonparametric"):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * (var + eps) ** -0.5
        if kind == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
        return y.to(x.dtype)
    raise ValueError(kind)
