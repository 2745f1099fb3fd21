"""Rounding to a lower precision than the configuration states: the
controls that a check of ``correct`` has to fail. Each rounds the operands
of a matrix product or convolution and leaves the float32 arithmetic
otherwise as it is."""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits, to nearest even),
    as the tensor cores read their float32 operands."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (amax to 448), as an fp8
    inference path stores weights and activations."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-30) / 448.0
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"f32": None, "tf32": tf32, "fp8": fp8}


def rounder(precision: str):
    if precision not in ROUND:
        raise ValueError(f"unknown precision {precision!r}")
    return ROUND[precision]
