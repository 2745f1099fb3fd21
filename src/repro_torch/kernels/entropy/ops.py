"""Two-phase batched Huffman encode on the device, and kernel K3.

* **Phase 1 — histogram.** PyTorch ops on the tensor's device quantize the
  (B, n) stack and count symbols with one ``bincount`` over
  ``sample * 2^c + code``. Only the ``(B, 2^c)`` counts and the (B,)
  ranges reach the host.
* **Host tables.** The canonical code table of each histogram
  (:mod:`repro_torch.core.entropy`) becomes per-sample ``(code, length)``
  lookup tables, and each sample's exact ``total_bits`` is known before
  the pack launches.
* **Phase 2 — K3** (``csrc/huffman_pack.cu``, :func:`huffman_pack`):
  re-quantize, table gather, prefix sum of the code lengths across blocks,
  emission into u32 words. Each word row written big-endian and trimmed to
  ``ceil(total_bits / 8)`` bytes is the host encoder's bitstream, byte for
  byte.

Routing is the reference's, kept exactly: a sample with a code longer than
``PACK_MAX_CODE_BITS`` or a stream past ``_MAX_TOTAL_BITS`` (and a batch
whose padded word grid passes it) makes :func:`huffman_encode_batch_device`
return ``None``, and the codec encodes on the host instead. That is a
semantic route of the codec, not a kernel fallback; ``HOST_ROUTES`` counts
it. ``PACK_LAUNCHES`` counts K3's CUDA kernel launches (three per call).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import entropy as ent
from repro_torch.core.quantization import affine_scale
from repro_torch.kernels import build

# A code may span at most two u32 words in the emission.
PACK_MAX_CODE_BITS = 32
# Per-sample bit offsets are int32 in the kernel.
_MAX_TOTAL_BITS = (1 << 31) - 1
# Word-grid width quantum of the reference (its routing check depends on it).
_LANES = 128

PACK_LAUNCHES = 0
HOST_ROUTES = 0


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def _hist_ranges(xb: torch.Tensor, bits: int):
    """Per-sample symbol histogram and affine range of a (B, n) stack. The
    quantize is written exactly as ``core.quantization.quantize``, so the
    counted codes are the ones K3 re-derives."""
    bsz = xb.shape[0]
    xf = xb.to(torch.float32)
    mn = xf.amin(dim=1)
    mx = xf.amax(dim=1)
    levels = (1 << bits) - 1
    scale = affine_scale(mn, mx, bits)
    q = torch.clamp(torch.round((xf - mn[:, None]) * scale[:, None]),
                    0, levels).to(torch.int64)
    sid = torch.arange(bsz, device=xb.device, dtype=torch.int64) << bits
    hist = torch.bincount((q + sid[:, None]).reshape(-1),
                          minlength=bsz << bits).reshape(bsz, 1 << bits)
    return hist, mn, mx, scale


def _sample_table(freqs: np.ndarray, num_symbols: int):
    """Canonical table of one histogram: ``(code_of u32 (S,), len_of (S,),
    lengths (S,), total_bits)``, or ``None`` when the sample must take the
    host route (a code longer than ``PACK_MAX_CODE_BITS``, or a stream past
    ``_MAX_TOTAL_BITS``)."""
    lengths = ent._code_lengths(freqs.astype(np.int64))
    max_len = int(lengths.max())
    total_bits = int((freqs.astype(np.int64) * lengths).sum())
    if max_len > PACK_MAX_CODE_BITS or total_bits > _MAX_TOTAL_BITS:
        return None
    first_code, offset, _, rank_sym = ent._canonical_ranges(lengths)
    code_of = np.zeros(num_symbols, np.uint32)
    len_of = np.zeros(num_symbols, np.uint8)
    ls = lengths[rank_sym]
    code_of[rank_sym] = (first_code[ls] + np.arange(len(rank_sym))
                         - offset[ls])
    len_of[rank_sym] = ls
    return code_of, len_of, lengths, total_bits


def _w_words(max_bits: int) -> int:
    """Words per sample row, quantized as the reference quantizes them
    (powers of two up to 1024, then 1024-word steps)."""
    need = (max_bits + 31) // 32
    w = _LANES
    while w < need:
        w = w * 2 if w < 1024 else w + 1024
    return w


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def huffman_pack_ref(xb: torch.Tensor, mn: torch.Tensor, scale: torch.Tensor,
                     code_lut: torch.Tensor, len_lut: torch.Tensor,
                     bits: int, w_words: int) -> torch.Tensor:
    """Plain version of K3: (B, n) floats -> (B, w_words) int32 words
    holding the u32 bit patterns of each sample's bitstream."""
    bsz, n = xb.shape
    levels = (1 << bits) - 1
    q = torch.clamp(torch.round((xb.to(torch.float32) - mn[:, None])
                                * scale[:, None]), 0, levels).to(torch.int64)
    code = torch.gather(code_lut.to(torch.int64) & 0xFFFFFFFF, 1, q)
    length = torch.gather(len_lut.to(torch.int64), 1, q)
    start = torch.cumsum(length, dim=1) - length
    w0 = start >> 5
    o = start & 31
    spill = (o + length) > 32
    k1 = torch.clamp(o + length - 32, 0, 31)
    part0 = torch.where(spill, code >> k1,
                        code << torch.clamp(32 - o - length, 0, 31))
    part1 = torch.where(spill, (code << (32 - k1)) & 0xFFFFFFFF,
                        torch.zeros_like(code))
    # Parts never share bits, so the sums below are exact ORs.
    acc = torch.zeros((bsz, w_words + 1), dtype=torch.int64,
                      device=xb.device)
    acc.scatter_add_(1, w0, torch.where(length > 0, part0,
                                        torch.zeros_like(part0)))
    acc.scatter_add_(1, w0 + 1, part1)
    words = acc[:, :w_words]
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def huffman_pack(xb: torch.Tensor, mn: torch.Tensor, scale: torch.Tensor,
                 code_lut: torch.Tensor, len_lut: torch.Tensor, bits: int,
                 w_words: int) -> torch.Tensor:
    """K3 on a (B, n) stack with per-sample (mn, scale), (B, 2^c) int32
    code tables (u32 bit patterns) and (B, 2^c) u8 length tables (<= 32):
    (B, w_words) int32 words. CPU tensors run :func:`huffman_pack_ref`."""
    global PACK_LAUNCHES
    if xb.device.type == "cpu":
        return huffman_pack_ref(xb, mn, scale, code_lut, len_lut, bits,
                                w_words)
    if xb.device.type != "cuda":
        raise ValueError(f"huffman_pack: expected a CPU or CUDA tensor, got "
                         f"{xb.device}")
    if xb.dtype not in (torch.float32, torch.bfloat16):
        xb = xb.to(torch.float32)
    xb = xb.contiguous()
    bsz, n = xb.shape
    if (tuple(code_lut.shape) != (bsz, 1 << bits)
            or tuple(len_lut.shape) != (bsz, 1 << bits)
            or mn.numel() != bsz or scale.numel() != bsz):
        raise ValueError("huffman_pack: tables must be (B, 2^bits) and "
                         "ranges (B,)")
    lib = build.load("huffman_pack")
    chunk_fn = lib.jalad_huffman_chunk
    chunk_fn.argtypes = []
    chunk_fn.restype = ctypes.c_int
    chunks = max(1, -(-n // chunk_fn()))
    dev = xb.device
    tensors = [t.contiguous() for t in (mn.to(torch.float32),
                                        scale.to(torch.float32),
                                        code_lut.to(torch.int32),
                                        len_lut.to(torch.uint8))]
    chunk_bits = torch.empty((bsz, chunks), dtype=torch.int32, device=dev)
    words = torch.empty((bsz, w_words), dtype=torch.int32, device=dev)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.jalad_huffman_pack
    fn.argtypes = [p, i, i, ll, i, p, p, p, p, i, p, p, ll, p]
    fn.restype = ctypes.c_int
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    status = fn(ctypes.c_void_p(xb.data_ptr()),
                int(xb.dtype == torch.bfloat16), bsz, n, bits, *ptr, chunks,
                ctypes.c_void_p(chunk_bits.data_ptr()),
                ctypes.c_void_p(words.data_ptr()), w_words,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.check(status, "huffman_pack")
    PACK_LAUNCHES += 3
    return words


# ---------------------------------------------------------------------------
# The batched encode
# ---------------------------------------------------------------------------


def huffman_encode_batch_device(xb: torch.Tensor, bits: int
                                ) -> Optional[Tuple[List[bytes], np.ndarray,
                                                    np.ndarray]]:
    """Batched Huffman encode of a (B, *shape) float stack on its device.

    Returns ``(payloads, mn, mx)``: per-sample payloads byte-identical to
    ``ent.huffman_encode`` of that sample's quantized codes, and the (B,)
    ranges. Returns ``None`` when any sample needs the host route."""
    bsz = xb.shape[0]
    n_elem = int(np.prod(xb.shape[1:])) if xb.ndim > 1 else 1
    if bsz == 0 or n_elem == 0:
        return None
    num_symbols = 1 << bits
    xb2 = xb.reshape(bsz, n_elem)
    hist_d, mn_d, mx_d, scale_d = _hist_ranges(xb2, bits)
    hist = hist_d.cpu().numpy()
    mn = mn_d.cpu().numpy()
    mx = mx_d.cpu().numpy()

    tables = []
    for b in range(bsz):
        t = _sample_table(hist[b], num_symbols)
        if t is None:
            return None
        tables.append(t)
    w_words = _w_words(max(t[3] for t in tables))
    # The reference packs the batch as one stream based at 32 * w_words * b.
    if 32 * w_words * bsz > _MAX_TOTAL_BITS:
        return None

    code_lut = np.stack([t[0] for t in tables]).view(np.int32)
    len_lut = np.stack([t[1] for t in tables])
    dev = xb.device
    words = huffman_pack(xb2, mn_d, scale_d,
                         torch.from_numpy(code_lut).to(dev),
                         torch.from_numpy(len_lut).to(dev), bits, w_words)
    words = words.cpu().numpy().view(np.uint32)

    head = (np.uint32(n_elem).tobytes()
            + np.uint16(num_symbols & 0xFFFF).tobytes())
    payloads = []
    for b, (_, _, lengths, total_bits) in enumerate(tables):
        stream = words[b].astype(">u4").tobytes()[: (total_bits + 7) // 8]
        payloads.append(head + lengths.astype(np.uint8).tobytes() + stream)
    return payloads, mn, mx
