"""JALAD's c-bit min-max quantization, quantized and dequantized in plain
float32 (paper Sec. III-B): the value transform of the wire codecs, and
the symmetric int8 rows of the cloud's KV cache."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def codes(x: torch.Tensor, bits: int, reduce_dims: Optional[tuple]):
    """The range, the number of levels and each element's code before it
    is rounded: ``(x - min) (2^c - 1) / (max - min)``."""
    xf = x.float()
    if reduce_dims is None:
        mn, mx = xf.min(), xf.max()
    else:
        mn = xf.amin(dim=reduce_dims, keepdim=True)
        mx = xf.amax(dim=reduce_dims, keepdim=True)
    levels = float((1 << bits) - 1)
    span = mx - mn
    # A true division: ``float / tensor`` multiplies by a reciprocal,
    # which can move a code across a rounding edge.
    scale = torch.where(span > 0, torch.full_like(span, levels) / span,
                        torch.zeros_like(span))
    return mn, span, levels, (xf - mn) * scale


def minmax_qdq(x: torch.Tensor, bits: int,
               reduce_dims: Optional[tuple] = None) -> torch.Tensor:
    """``clip(round((x - min) (2^c - 1) / (max - min)), 0, 2^c - 1)``, then
    ``q (max - min) / (2^c - 1) + min``; the range over the whole tensor,
    or over ``reduce_dims`` (one range a channel)."""
    mn, span, levels, u = codes(x, bits, reduce_dims)
    q = torch.clamp(torch.round(u), 0, levels)
    return q * (span / levels) + mn


def minmax_qdq_bounds(x: torch.Tensor, bits: int,
                      reduce_dims: Optional[tuple] = None,
                      edge: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lowest and highest value that a sound float32 program may give
    each element of ``minmax_qdq(x, bits, reduce_dims)``. Where the code
    before rounding lies within ``edge`` (in codes) of a rounding edge,
    the last bits of ``x`` decide the side, so the codes on both sides
    are the reference's answer; elsewhere the rounded code is."""
    mn, span, levels, u = codes(x, bits, reduce_dims)
    q = torch.round(u)
    below = torch.floor(u)
    near = (u - below - 0.5).abs() <= edge
    lo = torch.clamp(torch.where(near, below, q), 0, levels)
    hi = torch.clamp(torch.where(near, below + 1, q), 0, levels)
    step = span / levels
    return lo * step + mn, hi * step + mn


def codec_dims(x: torch.Tensor, codec: str) -> Optional[tuple]:
    if codec == "bitpack":
        return None
    if codec == "perchannel":
        axis = 1 if x.ndim == 4 else x.ndim - 1
        return tuple(i for i in range(x.ndim) if i != axis)
    raise ValueError(f"no plain reference for codec {codec!r}")


def codec_qdq(x: torch.Tensor, bits: int, codec: str) -> torch.Tensor:
    """The value a boundary ``x`` takes across the wire: ``bitpack`` ranges
    over the whole tensor; ``perchannel`` over each channel, dim 1 of an
    NCHW tensor and the last dim otherwise."""
    return minmax_qdq(x, bits, codec_dims(x, codec))


def codec_qdq_bounds(x: torch.Tensor, bits: int, codec: str,
                     edge: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``codec_qdq``'s lowest and highest sound value of each element (see
    ``minmax_qdq_bounds``)."""
    return minmax_qdq_bounds(x, bits, codec_dims(x, codec), edge)


def int8_row_qdq(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 over the last dim: ``round(127 x / amax)``, clipped
    to [-127, 127], times ``amax / 127``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127) * scale
