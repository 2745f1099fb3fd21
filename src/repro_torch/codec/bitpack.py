"""Device-side boundary codec: fused quantize + pack, no entropy stage.

Edge: kernel K1 (``quantize_pack``) reduces the range, quantizes and packs
on the device; the host only copies the codes and frames the bytes. Cloud:
the bytes go back to the device and kernel K2 (``dequantize_wire``)
unpacks, dequantizes and casts in one launch. ``encode_batch`` /
``decode_batch`` run one launch for a stack of same-shape tensors.

Wire format: nibble-packed u8 for bits <= 4 (two codes per byte), one u8
per element for bits <= 8, little-endian u16 above. The size is
shape-only, so the S_i(c) predictor needs no data pass.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.codec.base import (
    BoundaryCodec,
    WireBlob,
    ranges_f32,
    register_codec,
    stackable_shapes,
    wire_span,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import (
    dequantize_wire,
    dequantize_wire_batch,
    quantize_pack,
    quantize_pack_stack,
)


def _payload_bytes(n: int, bits: int) -> int:
    if bits <= 4:
        return (n + 1) // 2
    if bits <= 8:
        return n
    return 2 * n


def _frame(codes: np.ndarray, bits: int) -> bytes:
    """Host framing of one sample's flat wire codes."""
    if bits <= 8:
        return codes.tobytes()
    return codes.astype("<u2").tobytes()


class BitpackCodec(BoundaryCodec):
    name = "bitpack"
    value_key = "tensor"

    @wire_span("encode")
    def encode(self, x: torch.Tensor, bits: int) -> WireBlob:
        shape = tuple(x.shape)
        if x.numel() == 0:
            return WireBlob(self.name, b"", shape, bits,
                            np.float32(0.0), np.float32(0.0))
        codes, mn, mx = quantize_pack(x, bits)
        rng = torch.stack([mn, mx]).cpu().numpy()
        return WireBlob(self.name, _frame(codes.cpu().numpy(), bits), shape,
                        bits, np.float32(rng[0]), np.float32(rng[1]))

    @wire_span("encode")
    def encode_batch(self, xs: Sequence[torch.Tensor], bits: int
                     ) -> List[WireBlob]:
        xs = list(xs)
        shapes = [tuple(x.shape) for x in xs]
        if not stackable_shapes(shapes):
            return [self.encode(x, bits) for x in xs]
        codes, mn, mx = quantize_pack_stack(xs, bits)
        flat = codes.cpu().numpy()
        mn = mn.cpu().numpy()
        mx = mx.cpu().numpy()
        return [WireBlob(self.name, _frame(flat[i], bits), shapes[0], bits,
                         np.float32(mn[i]), np.float32(mx[i]))
                for i in range(len(xs))]

    def _wire_codes(self, blob: WireBlob) -> np.ndarray:
        if blob.bits <= 8:
            return np.frombuffer(blob.payload, np.uint8)
        return np.frombuffer(blob.payload, "<u2").astype(np.uint16)

    @wire_span("decode")
    def decode(self, blob: WireBlob, out_dtype=torch.float32,
               device=None) -> torch.Tensor:
        dev = resolve_device(device)
        if blob.num_elements == 0:
            return torch.zeros(blob.shape, dtype=out_dtype, device=dev)
        codes = torch.from_numpy(self._wire_codes(blob).copy()).to(dev)
        return dequantize_wire(codes, blob.x_min, blob.x_max, blob.bits,
                               blob.shape, out_dtype)

    @wire_span("decode")
    def decode_batch(self, blobs: Sequence[WireBlob], out_dtype=torch.float32,
                     device=None) -> List[torch.Tensor]:
        blobs = list(blobs)
        shapes = [b.shape for b in blobs]
        if (not stackable_shapes(shapes)
                or len({b.bits for b in blobs}) != 1):
            return [self.decode(b, out_dtype, device) for b in blobs]
        dev = resolve_device(device)
        flat = torch.from_numpy(
            np.stack([self._wire_codes(b) for b in blobs])).to(dev)
        mn, mx = ranges_f32(blobs)
        out = dequantize_wire_batch(flat, mn, mx, blobs[0].bits,
                                    blobs[0].shape, out_dtype)
        return list(out.unbind(0))

    def wire_size_bytes(self, shape: Tuple[int, ...], bits: int) -> int:
        n = int(np.prod(shape)) if shape else 1
        return _payload_bytes(n, bits) + 9

    def transfer_size_batch(self, x: torch.Tensor, bits_list: Sequence[int]
                            ) -> List[int]:
        """Fixed rate: shape-only sizes, no device work."""
        n = int(x.numel())
        return [_payload_bytes(n, int(b)) + 9 for b in bits_list]


register_codec(BitpackCodec())
