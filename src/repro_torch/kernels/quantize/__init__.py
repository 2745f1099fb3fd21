"""Boundary-codec quantize kernels: K1 (fused encode) and K2 (fused
decode) per tensor, K4 and K5 per channel, and the three-launch encode
chain K6a, K6b, K6c, with their plain PyTorch versions in ``ref.py``."""
from repro_torch.kernels.quantize.ops import (
    count_launches,
    dequantize_codes,
    dequantize_codes_batch,
    dequantize_codes_batch_sharded,
    dequantize_unpack,
    dequantize_wire,
    dequantize_wire_batch,
    dequantize_wire_batch_sharded,
    launch_counts,
    minmax_blocks,
    pack4_blocks,
    perchannel_decode,
    perchannel_decode_batch,
    perchannel_encode,
    perchannel_encode_batch,
    perchannel_encode_stack,
    perchannel_words,
    quantize_blocks,
    quantize_dequantize_kernel,
    quantize_pack,
    quantize_pack_batch,
    quantize_pack_stack,
    quantize_pack_threelaunch,
    reset_launch_counts,
)

# The reference's public names; the port's own (the sharded decodes, the
# K6 chain's kernels and the launch counters) stay importable by name.
__all__ = [
    "count_launches",
    "dequantize_codes",
    "dequantize_codes_batch",
    "dequantize_unpack",
    "dequantize_wire",
    "dequantize_wire_batch",
    "perchannel_decode",
    "perchannel_decode_batch",
    "perchannel_encode",
    "perchannel_encode_batch",
    "perchannel_encode_stack",
    "perchannel_words",
    "quantize_dequantize_kernel",
    "quantize_pack",
    "quantize_pack_batch",
    "quantize_pack_stack",
    "quantize_pack_threelaunch",
]
