"""Quantize -> Huffman glue of the paper's first codec, kept as the
reference keeps it (``repro.core.compression``, a deprecated shim beside
the codec registry).

``compress`` delegates to the registered ``huffman`` codec of
:mod:`repro_torch.codec`, so its payload is that codec's blob payload: on
a CUDA tensor the device histogram and kernel K3, on a CPU tensor their
plain versions. ``decompress`` is the pure host-side reference decoder
(numpy), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import entropy as ent

# NB: ``repro_torch.codec`` is imported lazily inside the functions below:
# the codec package itself depends on ``repro_torch.core.quantization``,
# and importing it here would cycle when ``repro_torch.codec`` is imported
# first.


@dataclass(frozen=True)
class CompressedFeatures:
    payload: bytes            # Huffman bitstream (header included)
    shape: Tuple[int, ...]
    x_min: float
    x_max: float
    bits: int

    @property
    def nbytes(self) -> int:
        # payload + range header (2 x f32) + bits byte
        return len(self.payload) + 9


def compress(x, bits: int) -> CompressedFeatures:
    """Quantize a float feature map (a tensor, or an array taken as one on
    the CPU) and Huffman-code it, on the tensor's device."""
    from repro_torch.codec import get_codec

    blob = get_codec("huffman").encode(torch.as_tensor(x), bits)
    return CompressedFeatures(
        blob.payload, blob.shape, float(blob.x_min), float(blob.x_max), bits,
    )


def decompress(c: CompressedFeatures, dtype=np.float32) -> np.ndarray:
    """Pure host-side reference decode (numpy; no kernel launch)."""
    codes = decompress_codes(c)
    levels = (1 << c.bits) - 1
    step = (c.x_max - c.x_min) / levels if levels else 0.0
    return (codes.astype(np.float32) * step + c.x_min).astype(dtype)


def decompress_codes(c: CompressedFeatures) -> np.ndarray:
    """Huffman-decode only; returns the integer codes (the dequant + cast
    half of the codec is kernel K2 on the cloud card, see
    ``repro_torch.kernels.quantize.dequantize_codes``)."""
    if not c.payload:       # zero-element boundary: empty payload, no header
        return np.zeros(c.shape, np.int64)
    return ent.huffman_decode(c.payload).reshape(c.shape)


def transfer_size_bytes(x, bits: int) -> int:
    """Exact post-Huffman transfer size of a feature map at c bits (without
    building the bitstream), from the histogram on the tensor's device."""
    from repro_torch.codec import get_codec

    return get_codec("huffman").transfer_size_bytes(torch.as_tensor(x), bits)
