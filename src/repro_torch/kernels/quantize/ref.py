"""Plain PyTorch versions of the quantize kernels K1 and K2.

They compute exactly what ``csrc/quantize.cu`` computes, on any device:
the wrappers in :mod:`repro_torch.kernels.quantize.ops` run them for CPU
tensors, the CPU tests hold them byte- and bit-identical to the reference
kernels, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card. Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quantization import affine_scale, fma_f32


def code_dtype(bits: int) -> torch.dtype:
    """Narrowest unsigned integer dtype that holds a c-bit code."""
    return torch.uint8 if bits <= 8 else torch.uint16


def wire_len(n: int, bits: int) -> int:
    """Wire codes per sample: two codes per byte for bits <= 4."""
    return (n + 1) // 2 if bits <= 4 else n


def fused_encode_ref(xb: torch.Tensor, bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: (B, n) float -> (codes (B, wire_len), mn (B,), mx (B,)).

    Per-sample min/max, ``clip(round((x - mn) * scale), 0, 2^c - 1)``,
    then nibble pairs ``lo | hi << 4`` (c <= 4; an odd count repeats
    element 0 in the last high nibble), u8 (c <= 8) or u16 codes."""
    bsz, n = xb.shape
    xf = xb.to(torch.float32)
    mn = xf.amin(dim=1)
    mx = xf.amax(dim=1)
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
