"""JALAD's in-layer feature quantization (paper Sec. III-B), in PyTorch.

The paper's step conversion maps the float feature map affinely into
``[0, 2^c)`` and rounds:

    q = clip(round((x - min) * (2^c - 1) / (max - min)), 0, 2^c - 1)

``torch.round`` rounds half to even, like the reference's ``jnp.round``,
so the codes are bit-identical. The dequantize ``q * step + min`` must
round ONCE, as the reference's jitted decode (and the CUDA decode kernel's
``fmaf``) does; :func:`fma_f32` gives that on any device.

``axis=`` selects per-channel ranges (beyond the paper: tighter ranges,
lower error at the same width), the value transform of the ``perchannel``
codec. :func:`pack_bits` / :func:`unpack_bits` are the reference's dense
c-bit packing, the oracle of the per-channel kernels' word layout.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Quantized(NamedTuple):
    """Quantized feature map + the affine range needed to invert."""

    values: torch.Tensor    # integer codes, same shape as input (int32)
    x_min: torch.Tensor     # per-tensor 0-d tensor or per-channel vector
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


def dequant_recip(bits: int) -> float:
    """``f32(1) / f32(2^c - 1)``, the float32 constant by which the decode
    multiplies ``mx - mn`` to get the step (exactly representable as a
    Python float). The CUDA decode kernels take it as an argument."""
    return float(np.float32(1.0) / np.float32((1 << bits) - 1))


def dequant_step(mn: torch.Tensor, mx: torch.Tensor, bits: int
                 ) -> torch.Tensor:
    """``(mx - mn) / (2^c - 1)`` as the reference's compiled decode
    evaluates it: XLA folds a division by a constant into a multiplication
    by its float32 reciprocal, so the step is ``(mx - mn) *``
    :func:`dequant_recip`. Both operands are tensors, so the product is one
    IEEE multiply on every device."""
    return (mx - mn) * torch.full_like(mn, dequant_recip(bits))


# -0.0 seen as an int32.
_NEG_ZERO_BITS = -(1 << 31)


def _zero_signed(r: torch.Tensor, x: torch.Tensor, dim, neg: bool
                 ) -> torch.Tensor:
    """``r`` (a minimum (``neg``) or maximum of float32 ``x`` over ``dim``)
    with a zero made ``-0.0`` (``+0.0``) where ``x`` holds that zero. A
    zero ``r`` is one of ``x``'s, so where ``x`` holds no such zero it is
    already the other one."""
    kw = {} if dim is None else {"dim": dim}
    held = (x.view(torch.int32) == (_NEG_ZERO_BITS if neg else 0)).any(**kw)
    return torch.where(held & (r == 0), -0.0 if neg else 0.0, r)


def ordered_amin(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.amin(dim)`` of float32 ``x`` (every dim when ``dim`` is None)
    in the reference's order, in which ``-0.0 < +0.0``: a zero minimum is
    ``-0.0`` wherever the values hold a ``-0.0``. ``torch.amin`` returns
    whichever zero it meets first, and that order differs between devices;
    ``jnp.min`` returns ``-0.0`` in either order. NaN is left as ``amin``
    gives it."""
    return _zero_signed(x.amin() if dim is None else x.amin(dim), x, dim,
                        True)


def ordered_amax(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.amax(dim)`` in the order of :func:`ordered_amin`: a zero maximum
    is ``+0.0`` wherever the values hold a ``+0.0``."""
    return _zero_signed(x.amax() if dim is None else x.amax(dim), x, dim,
                        False)


def ordered_aminmax(x: torch.Tensor, dim=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ordered_amin(x, dim), ordered_amax(x, dim))`` from one
    ``torch.aminmax`` (``dim`` None or one dim; a tuple of dims takes
    ``amin`` and ``amax``)."""
    if isinstance(dim, tuple):
        mn, mx = x.amin(dim), x.amax(dim)
    else:
        mn, mx = torch.aminmax(x) if dim is None else torch.aminmax(x,
                                                                   dim=dim)
    return _zero_signed(mn, x, dim, True), _zero_signed(mx, x, dim, False)


def _channel_view(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A (C,) range vector shaped to broadcast along ``axis``."""
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def quantize(x: torch.Tensor, bits: int, axis: Optional[int] = None
             ) -> Quantized:
    """Min-max step quantization: the paper's per-tensor version, or
    per-channel statistics along ``axis``."""
    xf = x.to(torch.float32)
    if axis is None:
        x_min, x_max = mn, mx = ordered_aminmax(xf)
    else:
        reduce = tuple(i for i in range(x.ndim) if i != axis)
        # ``amin(dim=())`` would reduce every dim; a 1-D tensor's channels
        # are its elements.
        x_min, x_max = ordered_aminmax(xf, reduce) if reduce else (xf, xf)
        mn = _channel_view(x_min, x.ndim, axis)
        mx = _channel_view(x_max, x.ndim, axis)
    scale = affine_scale(mn, mx, bits)
    q = torch.clamp(torch.round((xf - mn) * scale), 0, (1 << bits) - 1)
    return Quantized(q.to(torch.int32), x_min, x_max, bits)


def dequantize(q: Quantized, dtype=torch.float32, axis: Optional[int] = None
               ) -> torch.Tensor:
    mn, mx = q.x_min, q.x_max
    if mn.ndim:
        ax = axis if axis is not None else 0
        mn = _channel_view(mn, q.values.ndim, ax)
        mx = _channel_view(mx, q.values.ndim, ax)
    step = dequant_step(mn, mx, q.bits)
    return fma_f32(q.values.to(torch.float32), step, mn).to(dtype)


def quantize_dequantize(x: torch.Tensor, bits: int,
                        axis: Optional[int] = None) -> torch.Tensor:
    """Straight-through simulation of the edge->cloud quantization (the
    path used inside calibration)."""
    return dequantize(quantize(x, bits, axis), x.dtype, axis)


def quantization_mse(x: torch.Tensor, bits: int) -> torch.Tensor:
    xq = quantize_dequantize(x, bits)
    return torch.mean(torch.square(x.to(torch.float32)
                                   - xq.to(torch.float32)))


# ---------------------------------------------------------------------------
# Bit packing: c-bit codes -> dense 32-bit words, ``32 // bits`` codes per
# word, code k at bit ``k * bits`` (codes never straddle a word, so
# non-power-of-two widths leave ``32 % bits`` high bits 0). Words are
# int32 tensors holding the u32 bit patterns.
# ---------------------------------------------------------------------------


def u32_as_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int codes (< 2^bits) along the last dim into words, padded to
    whole words: (..., n) -> (..., ceil(n / (32 // bits))). A 1-D input is
    the reference's flat packing."""
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in [1,16], got {bits}")
    per_word = 32 // bits
    q = codes.to(torch.int64)
    q = torch.nn.functional.pad(q, (0, (-q.shape[-1]) % per_word))
    shifts = torch.arange(per_word, device=q.device) * bits
    # The codes occupy disjoint bits, so the sum is their OR.
    words = (q.reshape(q.shape[:-1] + (-1, per_word)) << shifts).sum(dim=-1)
    return u32_as_i32(words)


def unpack_bits(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) words -> (..., n) int32."""
    per_word = 32 // bits
    shifts = torch.arange(per_word, device=words.device) * bits
    w = words.to(torch.int64) & 0xFFFFFFFF
    codes = (w[..., None] >> shifts) & ((1 << bits) - 1)
    return codes.reshape(words.shape[:-1] + (-1,))[..., :n].to(torch.int32)


def packed_size_bytes(num_values: int, bits: int) -> int:
    """Size of the bit-packed codes plus the 8-byte (min, max) header."""
    per_word = 32 // bits
    return (num_values + per_word - 1) // per_word * 4 + 8
