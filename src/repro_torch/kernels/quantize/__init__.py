"""Boundary-codec quantize kernels: K1 (fused encode) and K2 (fused
decode), with their plain PyTorch versions in ``ref.py``."""
from repro_torch.kernels.quantize.ops import (
    count_launches,
    dequantize_codes,
    dequantize_codes_batch,
    dequantize_wire,
    dequantize_wire_batch,
    launch_counts,
    quantize_pack,
    quantize_pack_batch,
    quantize_pack_stack,
    reset_launch_counts,
)

__all__ = [
    "count_launches",
    "dequantize_codes",
    "dequantize_codes_batch",
    "dequantize_wire",
    "dequantize_wire_batch",
    "launch_counts",
    "quantize_pack",
    "quantize_pack_batch",
    "quantize_pack_stack",
    "reset_launch_counts",
]
