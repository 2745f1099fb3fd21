"""The paper's boundary codec: per-tensor min-max quantize + canonical
Huffman entropy coding (Sec. III-B).

Edge: the two-phase batched encode of :mod:`repro_torch.kernels.entropy`
— a device histogram (only the ``(B, 2^bits)`` counts reach the host,
where the canonical table is built) and kernel K3, which emits the packed
bitstream words. Deep-tree distributions (a code longer than
``PACK_MAX_CODE_BITS``) take the host encoder of
:mod:`repro_torch.core.entropy`, as in the reference.

Cloud: Huffman decode on the host, then kernel K2 (``dequantize_codes``;
one ``dequantize_codes_batch`` launch for a stack) dequantizes and casts.
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
)
from repro_torch.core import entropy as ent
from repro_torch.core import quantization as q
from repro_torch.device import resolve_device
from repro_torch.kernels.entropy import ops as eops
from repro_torch.kernels.quantize import (
    dequantize_codes,
    dequantize_codes_batch,
)


def _calib_histograms(x: torch.Tensor, bits_list: Tuple[int, ...]
                      ) -> np.ndarray:
    """Symbol histograms of the quantized boundary at every bit width,
    counted on the tensor's device: ``(C, 2^max_bits)`` on the host."""
    n_max = 1 << max(bits_list)
    return torch.stack([
        torch.bincount(q.quantize(x, bits).values.reshape(-1).to(torch.int64),
                       minlength=n_max)
        for bits in bits_list
    ]).cpu().numpy()


class HuffmanCodec(BoundaryCodec):
    name = "huffman"
    value_key = "tensor"

    def _encode_host(self, x: torch.Tensor, bits: int) -> WireBlob:
        """Host route: quantize, copy all codes, numpy bitstream build."""
        eops.HOST_ROUTES += 1
        quantized = q.quantize(x, bits)
        payload = ent.huffman_encode(quantized.values.cpu().numpy(),
                                     1 << bits)
        return WireBlob(self.name, payload, tuple(x.shape), bits,
                        np.float32(quantized.x_min.item()),
                        np.float32(quantized.x_max.item()))

    def encode(self, x: torch.Tensor, bits: int) -> WireBlob:
        shape = tuple(x.shape)
        if x.numel() == 0:
            return WireBlob(self.name, b"", shape, bits,
                            np.float32(0.0), np.float32(0.0))
        dev = eops.huffman_encode_batch_device(x.unsqueeze(0), bits)
        if dev is None:
            return self._encode_host(x, bits)
        payloads, mn, mx = dev
        return WireBlob(self.name, payloads[0], shape, bits,
                        np.float32(mn[0]), np.float32(mx[0]))

    def encode_batch(self, xs: Sequence[torch.Tensor], bits: int
                     ) -> List[WireBlob]:
        xs = list(xs)
        shapes = [tuple(x.shape) for x in xs]
        if not stackable_shapes(shapes):
            return [self.encode(x, bits) for x in xs]
        dev = eops.huffman_encode_batch_device(torch.stack(xs), bits)
        if dev is None:
            return [self.encode(x, bits) for x in xs]
        payloads, mn, mx = dev
        return [WireBlob(self.name, payloads[i], shapes[i], bits,
                         np.float32(mn[i]), np.float32(mx[i]))
                for i in range(len(xs))]

    def decode(self, blob: WireBlob, out_dtype=torch.float32,
               device=None) -> torch.Tensor:
        dev = resolve_device(device)
        if blob.num_elements == 0:
            return torch.zeros(blob.shape, dtype=out_dtype, device=dev)
        codes = ent.huffman_decode(blob.payload)
        wide = np.uint8 if blob.bits <= 8 else np.uint16
        return dequantize_codes(torch.from_numpy(codes.astype(wide)).to(dev),
                                blob.x_min, blob.x_max, blob.bits,
                                blob.shape, out_dtype)

    def decode_batch(self, blobs: Sequence[WireBlob], out_dtype=torch.float32,
                     device=None) -> List[torch.Tensor]:
        blobs = list(blobs)
        shapes = [tuple(b.shape) for b in blobs]
        if (not stackable_shapes(shapes)
                or len({b.bits for b in blobs}) != 1):
            return [self.decode(b, out_dtype, device) for b in blobs]
        dev = resolve_device(device)
        bits = int(blobs[0].bits)
        wide = np.uint8 if bits <= 8 else np.uint16
        codes = np.stack([ent.huffman_decode(b.payload).astype(wide)
                          for b in blobs])
        mn, mx = ranges_f32(blobs)
        out = dequantize_codes_batch(torch.from_numpy(codes).to(dev), mn, mx,
                                     bits, shapes[0], out_dtype)
        return list(out.unbind(0))

    def wire_size_bytes(self, shape: Tuple[int, ...], bits: int) -> int:
        """Upper bound: the fixed-width payload plus the length table."""
        n = int(np.prod(shape)) if shape else 1
        table = 6 + (1 << bits)
        return table + (n * bits + 7) // 8 + 9

    def transfer_size_bytes(self, x: torch.Tensor, bits: int) -> int:
        """Exact post-Huffman size from the device histogram."""
        return self.transfer_size_batch(x, (bits,))[0]

    def transfer_size_batch(self, x: torch.Tensor, bits_list: Sequence[int]
                            ) -> List[int]:
        """Exact post-Huffman sizes at every width from one histogram pass
        and one small host transfer."""
        bits_t = tuple(int(b) for b in bits_list)
        if not bits_t:
            return []
        if x.numel() == 0:
            return [9] * len(bits_t)
        hists = _calib_histograms(x, bits_t)
        return [ent.huffman_size_from_counts(hists[i, : 1 << bits]) + 9
                for i, bits in enumerate(bits_t)]


register_codec(HuffmanCodec())
