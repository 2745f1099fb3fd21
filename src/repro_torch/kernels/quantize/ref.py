"""Plain PyTorch versions of the quantize kernels K1, K2 (per-tensor), K4,
K5 (per-channel) and the three-launch encode chain K6a, K6b, K6c.

They compute exactly what ``csrc/quantize.cu``, ``csrc/perchannel.cu`` and
``csrc/threelaunch.cu`` compute, on any device: the wrappers in
:mod:`repro_torch.kernels.quantize.ops` run them for CPU tensors, the CPU
tests hold them byte- and bit-identical to the reference kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card. Nothing
on the main path calls them when a card is present.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import (
    affine_scale,
    dequant_step,
    fma_f32,
    ordered_aminmax,
    pack_bits,
    unpack_bits,
)


def code_dtype(bits: int) -> torch.dtype:
    """Narrowest unsigned integer dtype that holds a c-bit code."""
    return torch.uint8 if bits <= 8 else torch.uint16


def wire_len(n: int, bits: int) -> int:
    """Wire codes per sample: two codes per byte for bits <= 4."""
    return (n + 1) // 2 if bits <= 4 else n


def fused_encode_ref(xb: torch.Tensor, bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: (B, n) float -> (codes (B, wire_len), mn (B,), mx (B,)).

    Per-sample min/max (:func:`ordered_aminmax`: the reference's
    ``-0.0 < +0.0``), ``clip(round((x - mn) * scale), 0,
    2^c - 1)``, then nibble pairs ``lo | hi << 4`` (c <= 4; an odd count
    repeats element 0 in the last high nibble), u8 (c <= 8) or u16
    codes."""
    bsz, n = xb.shape
    xf = xb.to(torch.float32)
    mn, mx = ordered_aminmax(xf, 1)
    levels = (1 << bits) - 1
    scale = affine_scale(mn, mx, bits)
    q = torch.clamp(torch.round((xf - mn[:, None]) * scale[:, None]),
                    0, levels)
    if bits <= 4:
        qq = q.to(torch.uint8)
        if n % 2:
            qq = torch.cat([qq, qq[:, :1]], dim=1)
        return qq[:, 0::2] | (qq[:, 1::2] << 4), mn, mx
    return q.to(torch.int32).to(code_dtype(bits)), mn, mx


def fused_decode_ref(codes: torch.Tensor, mn: torch.Tensor,
                     step: torch.Tensor, n: int, packed: bool,
                     out_dtype=torch.float32) -> torch.Tensor:
    """K2: codes (B, W) + per-sample (mn, step) -> (B, n) ``out_dtype``.

    ``packed`` codes hold element i in byte ``i >> 1`` (low nibble when i
    is even). ``codes * step + mn`` rounds once, like ``fmaf``."""
    if packed:
        lo = codes & 0x0F
        hi = codes >> 4
        q = torch.stack([lo, hi], dim=-1).reshape(codes.shape[0], -1)[:, :n]
    else:
        q = codes[:, :n]
    q = q.to(torch.int32).to(torch.float32)
    return fma_f32(q, step[:, None], mn[:, None]).to(out_dtype)


# ---------------------------------------------------------------------------
# Per-channel: K4 encode, K5 decode
# ---------------------------------------------------------------------------


def channel_dims(shape: Sequence[int], axis: int) -> Tuple[int, int, int]:
    """(outer, C, inner) of a sample shape around its channel ``axis``:
    channel c's element ``l = o * inner + i`` sits at flat offset
    ``o * C * inner + c * inner + i``."""
    shape = tuple(int(s) for s in shape)
    return (int(np.prod(shape[:axis])), shape[axis],
            int(np.prod(shape[axis + 1:])))


def perchannel_words(length: int, bits: int) -> int:
    """u32 words per channel on the wire: ``32 // bits`` codes per word,
    codes never straddle a word and channels never share one."""
    per_word = 32 // bits
    return (length + per_word - 1) // per_word


def pc_encode_ref(xb: torch.Tensor, bits: int, axis: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: (B, *shape) float -> (words (B, C, W) int32 holding u32 bit
    patterns, mn (B, C), mx (B, C)).

    Per-(sample, channel) min/max in the order of :func:`ordered_amin`,
    ``clip(round((x - mn) * scale), 0, 2^c - 1)``, then :func:`pack_bits`
    along each channel: codes past the channel's length L are 0 and
    channels never share a word."""
    bsz = xb.shape[0]
    outer, c, inner = channel_dims(xb.shape[1:], axis)
    xc = (xb.to(torch.float32).reshape(bsz, outer, c, inner)
          .transpose(1, 2).reshape(bsz, c, outer * inner))
    mn, mx = ordered_aminmax(xc, 2)
    scale = affine_scale(mn, mx, bits)
    q = torch.clamp(torch.round((xc - mn[..., None]) * scale[..., None]),
                    0, (1 << bits) - 1)
    return pack_bits(q, bits), mn, mx


def pc_decode_ref(words: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                  bits: int, shape: Sequence[int], axis: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """K5: the inverse of K4. (B, C, W) words + (B, C) ranges -> (B,
    *shape) ``out_dtype``; ``codes * step + mn`` rounds once, like
    ``fmaf``, with ``step`` = :func:`dequant_step` per channel."""
    bsz, c, _ = words.shape
    outer, _, inner = channel_dims(shape, axis)
    codes = unpack_bits(words, bits, outer * inner)
    mn = mn.to(torch.float32)
    step = dequant_step(mn, mx.to(torch.float32), bits)
    out = fma_f32(codes.to(torch.float32), step[..., None], mn[..., None])
    out = out.to(out_dtype).reshape(bsz, c, outer, inner).transpose(1, 2)
    return out.reshape((bsz,) + tuple(int(s) for s in shape))


# ---------------------------------------------------------------------------
# Three-launch encode chain: K6a range, K6b quantize, K6c pack
# ---------------------------------------------------------------------------


def minmax_blocks_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a: a float tensor of n >= 1 elements -> its ``(mn, mx)``, two 0-d
    float32 tensors, in the reference's order (``-0.0 < +0.0``)."""
    return ordered_aminmax(x.reshape(-1).to(torch.float32))


def quantize_blocks_ref(x: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """K6b: a float tensor of n elements + 0-d float32 ``(mn, mx)`` ->
    (n,) codes ``clip(round((x - mn) * scale), 0, 2^c - 1)`` with the
    scale of :func:`affine_scale`, u8 at c <= 8, u16 above."""
    mn, mx = mn.to(torch.float32), mx.to(torch.float32)
    q = torch.clamp(torch.round((x.reshape(-1).to(torch.float32) - mn)
                                * affine_scale(mn, mx, bits)),
                    0, (1 << bits) - 1)
    return q.to(torch.int32).to(code_dtype(bits))


def pack4_blocks_ref(codes: torch.Tensor) -> torch.Tensor:
    """K6c: (n,) u8 codes < 16 -> (ceil(n / 2),) bytes ``codes[2i] |
    codes[2i + 1] << 4``; an odd count repeats ``codes[0]`` in the last
    high nibble, as the reference's first-element tile padding does."""
    q = codes.reshape(-1)
    if q.numel() % 2:
        q = torch.cat([q, q[:1]])
    return q[0::2] | (q[1::2] << 4)
