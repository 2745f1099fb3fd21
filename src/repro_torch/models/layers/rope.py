"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

M-RoPE [arXiv:2409.12191] splits the rotary dimension into (temporal,
height, width) sections and rotates each section by the corresponding
coordinate of the 3-D position id. For text tokens all three coordinates
are equal, which makes M-RoPE degenerate to standard RoPE on text (the
same angles, the same products, bit for bit).

Each row of a batch carries its own positions, so one batched decode step
can rotate slots that sit at different positions.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=device) / half
    base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / (base ** exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Apply rotation given per-position angles (..., seq, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); positions: (batch, seq) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (half,)
    angles = positions[..., None].float() * freqs                # (B,S,half)
    return _rotate(x, angles[:, :, None, :])                     # bcast heads


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); positions_3d: (batch, seq, 3).

    ``sections`` partitions head_dim//2 rotary channels into (t, h, w)
    groups; section sizes must sum to head_dim // 2.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (half,)
    # For each rotary channel pick which coordinate drives it.
    section_id = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                       device=x.device)
                            for i, s in enumerate(sections)])   # (half,)
    pos = positions_3d.float()[..., section_id]                  # (B,S,half)
    return _rotate(x, (pos * freqs)[:, :, None, :])


def text_positions_3d(positions: torch.Tensor) -> torch.Tensor:
    """Lift 1-D text positions to degenerate 3-D M-RoPE ids (t=h=w)."""
    return positions[..., None].repeat_interleave(3, dim=-1)
