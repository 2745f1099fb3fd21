"""Per-channel boundary codec: vector range headers + true c-bit packing.

Edge: kernel K4 (``perchannel_encode``) reduces each channel's range,
quantizes and packs ``32 // bits`` codes per u32 word on the device; the
host copies the words and frames the bytes. Cloud: the words go back to
the device and kernel K5 (``perchannel_decode``) unpacks, dequantizes per
channel and casts in one launch. ``encode_batch`` / ``decode_batch`` run
one launch for a stack of same-shape tensors, with per-(sample, channel)
ranges.

Wire layout (the reference's): channel-major, each channel's
``ceil(L / (32 // bits))`` little-endian u32 words, channels concatenated,
so channels never share a word. The header carries one float32 (min, max)
pair per channel, ``8 * C`` bytes the planner trades against the lower
error of per-channel ranges.

Channel axis: dim 1 of 4-D tensors (NCHW) and the trailing dim otherwise.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.codec.base import (
    BoundaryCodec,
    WireBlob,
    register_codec,
    stackable_shapes,
    wire_span,
)
from repro_torch.core import quantization as q
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import (
    perchannel_decode,
    perchannel_decode_batch,
    perchannel_encode,
    perchannel_encode_stack,
    perchannel_words,
)


def channel_axis(ndim: int) -> int:
    return 1 if ndim == 4 else max(ndim - 1, 0)


def _frame(words: np.ndarray) -> bytes:
    """Host framing of one sample's (C, W) words (int32 bit patterns)."""
    return words.view(np.uint32).astype("<u4").tobytes()


class PerChannelCodec(BoundaryCodec):
    name = "perchannel"
    value_key = "channel"

    @wire_span("encode")
    def encode(self, x: torch.Tensor, bits: int) -> WireBlob:
        shape = tuple(x.shape)
        ax = channel_axis(len(shape))
        if x.numel() == 0:
            zeros = np.zeros((shape[ax] if shape else 1,), np.float32)
            return WireBlob(self.name, b"", shape, bits, zeros, zeros,
                            axis=ax)
        words, mn, mx = perchannel_encode(x, bits, ax)
        return WireBlob(self.name, _frame(words.cpu().numpy()), shape, bits,
                        mn.cpu().numpy(), mx.cpu().numpy(), axis=ax)

    @wire_span("encode")
    def encode_batch(self, xs: Sequence[torch.Tensor], bits: int
                     ) -> List[WireBlob]:
        xs = list(xs)
        shapes = [tuple(x.shape) for x in xs]
        if not stackable_shapes(shapes):
            return [self.encode(x, bits) for x in xs]
        ax = channel_axis(len(shapes[0]))
        words, mn, mx = perchannel_encode_stack(xs, bits, ax)
        words = words.cpu().numpy()
        mn = mn.cpu().numpy()
        mx = mx.cpu().numpy()
        return [WireBlob(self.name, _frame(words[i]), shapes[0], bits, mn[i],
                         mx[i], axis=ax)
                for i in range(len(xs))]

    def _wire_words(self, blob: WireBlob) -> np.ndarray:
        c = blob.shape[blob.axis]
        length = blob.num_elements // c
        return (np.frombuffer(blob.payload, "<u4").astype(np.uint32)
                .view(np.int32).reshape(c, perchannel_words(length,
                                                            blob.bits)))

    @wire_span("decode")
    def decode(self, blob: WireBlob, out_dtype=torch.float32,
               device=None) -> torch.Tensor:
        dev = resolve_device(device)
        if blob.num_elements == 0:
            return torch.zeros(blob.shape, dtype=out_dtype, device=dev)
        words = torch.from_numpy(self._wire_words(blob)).to(dev)
        return perchannel_decode(words, blob.x_min, blob.x_max, blob.bits,
                                 blob.shape, blob.axis, out_dtype)

    @wire_span("decode")
    def decode_batch(self, blobs: Sequence[WireBlob], out_dtype=torch.float32,
                     device=None) -> List[torch.Tensor]:
        blobs = list(blobs)
        shapes = [b.shape for b in blobs]
        if (not stackable_shapes(shapes)
                or len({b.bits for b in blobs}) != 1):
            return [self.decode(b, out_dtype, device) for b in blobs]
        dev = resolve_device(device)
        first = blobs[0]
        words = torch.from_numpy(
            np.stack([self._wire_words(b) for b in blobs])).to(dev)
        mn = np.stack([b.x_min for b in blobs]).astype(np.float32)
        mx = np.stack([b.x_max for b in blobs]).astype(np.float32)
        out = perchannel_decode_batch(words, mn, mx, first.bits, first.shape,
                                      first.axis, out_dtype)
        return list(out.unbind(0))

    def wire_size_bytes(self, shape: Tuple[int, ...], bits: int) -> int:
        n = int(np.prod(shape)) if shape else 1
        c = shape[channel_axis(len(shape))] if shape else 1
        if n == 0 or c == 0:
            return 8 * c + 1
        return c * perchannel_words(n // c, bits) * 4 + 8 * c + 1

    def transfer_size_batch(self, x: torch.Tensor, bits_list: Sequence[int]
                            ) -> List[int]:
        """Fixed rate: shape-only sizes, no device work."""
        shape = tuple(x.shape)
        return [self.wire_size_bytes(shape, int(b)) for b in bits_list]

    def simulate(self, x: torch.Tensor, bits: int) -> torch.Tensor:
        return q.quantize_dequantize(x, bits, axis=channel_axis(x.ndim))


register_codec(PerChannelCodec())
