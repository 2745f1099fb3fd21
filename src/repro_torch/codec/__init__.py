"""Pluggable boundary codecs: the wire formats that carry quantized
boundary features across the edge-cloud link.

Importing this package registers the three codecs of the reference:

* ``huffman`` — the paper's codec: per-tensor quantize + Huffman (device
  histogram + kernel K3 on the edge, host decode + kernel K2 on the cloud).
* ``bitpack`` — fused quantize + pack on the device (kernels K1 / K2).
* ``perchannel`` — per-channel ranges + true c-bit packing on the device
  (kernels K4 / K5).
"""
from repro_torch.codec.base import (
    BoundaryCodec,
    StreamHeader,
    WireBlob,
    get_codec,
    list_codecs,
    register_codec,
)
from repro_torch.codec.huffman import HuffmanCodec
from repro_torch.codec.bitpack import BitpackCodec
from repro_torch.codec.perchannel import PerChannelCodec

__all__ = [
    "BoundaryCodec",
    "StreamHeader",
    "WireBlob",
    "get_codec",
    "list_codecs",
    "register_codec",
    "HuffmanCodec",
    "BitpackCodec",
    "PerChannelCodec",
]
