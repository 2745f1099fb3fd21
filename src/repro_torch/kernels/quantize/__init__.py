"""Boundary-codec quantize kernels: K1 (fused encode) and K2 (fused
decode) per tensor, K4 and K5 per channel, with their plain PyTorch
versions in ``ref.py``."""
from repro_torch.kernels.quantize.ops import (
    count_launches,
    dequantize_codes,
    dequantize_codes_batch,
    dequantize_wire,
    dequantize_wire_batch,
    launch_counts,
    perchannel_decode,
    perchannel_decode_batch,
    perchannel_encode,
    perchannel_encode_batch,
    perchannel_encode_stack,
    perchannel_words,
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
    "perchannel_decode",
    "perchannel_decode_batch",
    "perchannel_encode",
    "perchannel_encode_batch",
    "perchannel_encode_stack",
    "perchannel_words",
    "quantize_pack",
    "quantize_pack_batch",
    "quantize_pack_stack",
    "reset_launch_counts",
]
