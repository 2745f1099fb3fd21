"""Rotary position embeddings (standard RoPE; M-RoPE is not ported).

Each row of a batch carries its own positions, so one batched decode step
can rotate slots that sit at different positions.
"""
from __future__ import annotations

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
