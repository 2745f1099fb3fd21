"""JALAD's in-layer feature quantization (paper Sec. III-B), in PyTorch.

The paper's step conversion maps the float feature map affinely into
``[0, 2^c)`` and rounds:

    q = clip(round((x - min) * (2^c - 1) / (max - min)), 0, 2^c - 1)

``torch.round`` rounds half to even, like the reference's ``jnp.round``,
so the codes are bit-identical. The dequantize ``q * step + min`` must
round ONCE, as the reference's jitted decode (and the CUDA decode kernel's
``fmaf``) does; :func:`fma_f32` gives that on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Quantized(NamedTuple):
    """Quantized feature map + the affine range needed to invert."""

    values: torch.Tensor    # integer codes, same shape as input (int32)
    x_min: torch.Tensor     # 0-d tensors: the per-tensor range
    x_max: torch.Tensor
    bits: int


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` for float32 operands, rounded to float32 once.

    ``a * b`` is exact in float64 (24 + 24 significand bits). The float64
    sum can round a second time, so it is taken to round-to-odd: where the
    sum is inexact (its TwoSum error is non-zero) and its last bit is
    even, it moves one float64 step towards the exact value. A
    round-to-odd float64 (53 >= 24 + 2 bits) then rounds to float32
    exactly as a fused multiply-add would."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def affine_scale(mn: torch.Tensor, mx: torch.Tensor, bits: int
                 ) -> torch.Tensor:
    """``(2^c - 1) / (mx - mn)``, or 0 where ``mx == mn``. Both operands of
    the division are tensors: PyTorch evaluates ``scalar / tensor`` as a
    multiplication by the reciprocal, which can differ in the last bit and
    then move a code across a rounding edge."""
    levels = torch.full_like(mn, float((1 << bits) - 1))
    return torch.where(mx > mn, levels / (mx - mn), torch.zeros_like(mn))


def dequant_step(mn: torch.Tensor, mx: torch.Tensor, bits: int
                 ) -> torch.Tensor:
    """``(mx - mn) / (2^c - 1)`` as the reference's compiled decode
    evaluates it: XLA folds a division by a constant into a multiplication
    by its float32 reciprocal, so the step is ``(mx - mn) * f32(1 / (2^c -
    1))``. Both operands are tensors, so the product is one IEEE multiply
    on every device."""
    recip = float(np.float32(1.0) / np.float32((1 << bits) - 1))
    return (mx - mn) * torch.full_like(mn, recip)


def quantize(x: torch.Tensor, bits: int) -> Quantized:
    """The paper's per-tensor min-max step quantization."""
    xf = x.to(torch.float32)
    mn = xf.amin()
    mx = xf.amax()
    scale = affine_scale(mn, mx, bits)
    q = torch.clamp(torch.round((xf - mn) * scale), 0, (1 << bits) - 1)
    return Quantized(q.to(torch.int32), mn, mx, bits)


def dequantize(q: Quantized, dtype=torch.float32) -> torch.Tensor:
    step = dequant_step(q.x_min, q.x_max, q.bits)
    return fma_f32(q.values.to(torch.float32), step, q.x_min).to(dtype)


def quantize_dequantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Straight-through simulation of the edge->cloud quantization (the
    path used inside calibration)."""
    return dequantize(quantize(x, bits), x.dtype)
