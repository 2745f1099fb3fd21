"""Bytes the wire kernels have to move: each input byte read once, each
output byte written once (the kernels' roofline work).

Encode (K1 bitpack, K4 per-channel): the boundary in, the codes and the
range header out. Decode (K2, K5): the codes and header in, the boundary
out in the served dtype."""
from __future__ import annotations

import math


def payload_bytes(codec: str, shape, bits: int) -> int:
    n = math.prod(shape)
    if codec == "bitpack":
        return (n + 1) // 2 if bits <= 4 else (n if bits <= 8 else 2 * n)
    if codec == "perchannel":
        ch = shape[1] if len(shape) == 4 else shape[-1]
        per_word = 32 // bits
        return ch * (-(-(n // ch) // per_word)) * 4
    raise ValueError(f"no byte count for codec {codec!r}")


def header_bytes(codec: str, shape) -> int:
    if codec == "perchannel":
        return 8 * (shape[1] if len(shape) == 4 else shape[-1])
    return 8


def encode_bytes(codec: str, shape, bits: int, in_bytes: int = 4) -> int:
    return (math.prod(shape) * in_bytes + payload_bytes(codec, shape, bits)
            + header_bytes(codec, shape))


def decode_bytes(codec: str, shape, bits: int, out_bytes: int = 4) -> int:
    return (payload_bytes(codec, shape, bits) + header_bytes(codec, shape)
            + math.prod(shape) * out_bytes)
