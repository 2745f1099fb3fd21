"""Public wrappers of the quantize kernels: K1 (encode) and K2 (decode)
per tensor, K4 (encode) and K5 (decode) per channel, and the three-launch
encode chain K6a (range), K6b (quantize), K6c (nibble pack).

Dispatch rule, the same for every kernel wrapper of the port: a CPU tensor
runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor launches the
hand-written kernel of ``csrc/quantize.cu`` / ``csrc/perchannel.cu`` /
``csrc/threelaunch.cu`` or raises. There is no fallback from one to the
other.

Per-tensor codes are the flat *wire* layout, per sample: two codes per
byte for bits <= 4 (``(n + 1) // 2`` bytes), one u8 per element for
bits <= 8, one u16 per element above. These are exactly the bytes the
reference's bitpack codec ships after trimming its TPU tile padding.
Per-channel words are (B, C, W) int32 tensors holding the u32 words of the
reference's channel-major wire layout, exactly ``W = ceil(L / (32 //
bits))`` per channel.

The launch counters (:mod:`repro_torch.kernels.counters`) count CUDA
kernel launches: K1, K2, K4, K5 and each of K6a, K6b, K6c one a call.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import (
    dequant_recip,
    dequant_step,
)
from repro_torch.kernels import build
from repro_torch.kernels.counters import (  # noqa: F401  (re-exported)
    bump,
    count_launches,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.quantize import ref
from repro_torch.kernels.quantize.ref import (
    channel_dims,
    code_dtype,
    perchannel_words,
    wire_len,
)
from repro_torch.utils.trace import kernel_span, tensor_bytes

_THREADS = 256
# Blocks in flight across the card (132 SMs x 8 resident 256-thread blocks).
_GRID_TARGET = 1056


def _grid(work: int, batch: int) -> int:
    """Blocks per sample: enough to cover ``work`` at 4 items a thread, at
    most what fills the card across the whole batch."""
    want = -(-work // (_THREADS * 4))
    return max(1, min(want, max(1, _GRID_TARGET // batch)))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _fn(lib: str, name: str, argtypes):
    fn = getattr(build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")


# K1 (``csrc/quantize.cu``): one launch a call, in one of two variants
# that differ in how the blocks of a sample exchange their (min, max):
# "solo" (one block a sample) and "grid" (a cooperative launch of at most
# the blocks the card holds at once, split evenly over the samples).
# A block (512 threads) stages its share of the sample in at most
# FE_STAGE_BYTES of shared memory and reads the rest of the share again
# after the exchange. Shares start on multiples of FE_SHARE_UNIT elements.
FE_VARIANTS = ("solo", "grid")
FE_SHARE_UNIT = 64
FE_STAGE_BYTES = 200 * 1024
# fused_encode_plan picks "solo" for samples of at most this many elements
# and "grid" above: on the H100 (chip_smoke.py's K1 sweep) one block beat
# the grid at 8,192 float32 elements, tied at 16,384 and lost from 32,768
# up.
FE_SOLO_MAX = 16_384


@dataclass(frozen=True)
class FusedEncodePlan:
    """K1's launch: ``variant``, ``blocks`` a sample, the elements a block
    stages (a multiple of 8) and its dynamic shared memory."""
    variant: str
    blocks: int
    stage_elems: int
    smem_bytes: int


def fused_encode_shares(n: int, blocks: int):
    """The elements ``[e0, e1)`` of a sample each of its ``blocks`` blocks
    owns; the kernel splits the same way."""
    units = n // FE_SHARE_UNIT
    return [(r * units // blocks * FE_SHARE_UNIT,
             n if r == blocks - 1
             else (r + 1) * units // blocks * FE_SHARE_UNIT)
            for r in range(blocks)]


def fused_encode_plan(bsz: int, n: int, in_bf16: bool, resident: int,
                      variant: Optional[str] = None) -> FusedEncodePlan:
    """K1's launch for a (B, n) stack of float32 (or bfloat16) samples on a
    card that holds ``resident`` blocks of the grid variant at once.
    ``variant`` forces the variant (None picks it by size); a forced
    variant that cannot hold the stack raises ``ValueError``."""
    esize = 2 if in_bf16 else 4
    cap = FE_STAGE_BYTES // esize
    most = max(1, n // FE_SHARE_UNIT)          # blocks with a share each
    if variant is None:
        variant = "solo" if n <= FE_SOLO_MAX or bsz > resident else "grid"
    if variant not in FE_VARIANTS:
        raise ValueError(f"fused_encode: no variant {variant!r}")
    blocks = 1 if variant == "solo" else min(resident // bsz, most)
    if blocks < 1:
        raise ValueError(f"fused_encode: the {variant} variant cannot hold "
                         f"({bsz}, {n}) on a card of {resident} resident "
                         "blocks")
    longest = max(e1 - e0 for e0, e1 in fused_encode_shares(n, blocks))
    stage = min(-(-(longest + 7) // 8) * 8, cap)
    return FusedEncodePlan(variant, blocks, stage, stage * esize)


def _code_mode(bits: int) -> int:
    """The kernels' code layout: 0 nibble-packed u8, 1 u8, 2 u16."""
    return 0 if bits <= 4 else (1 if bits <= 8 else 2)


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, in_bf16: bool, mode: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        fn = _fn("quantize", "jalad_fused_encode_resident",
                 [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
        build.check(fn(int(in_bf16), (4, 8, 16)[mode], FE_STAGE_BYTES,
                       ctypes.byref(out)), "fused_encode occupancy")
    return out.value


def fused_encode_resident(device: torch.device, in_bf16: bool,
                          bits: int) -> int:
    """Blocks of K1's grid variant the card holds at once with a full
    FE_STAGE_BYTES stage each (the occupancy query times the SM count),
    queried once a device, input type and code layout."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _resident(index, in_bf16, _code_mode(bits))


@kernel_span("fused_encode", lambda out, xb, *_: tensor_bytes(xb, *out))
def fused_encode(xb: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on a (B, n) stack, n >= 1: (codes (B, wire_len), mn (B,), mx (B,))."""
    _check_bits(bits)
    if xb.device.type == "cpu":
        return ref.fused_encode_ref(xb, bits)
    return _fused_encode_cuda(xb, bits)


def _fused_encode_cuda(xb: torch.Tensor, bits: int,
                       variant: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's launch; ``variant`` forces the variant (``fused_encode`` lets
    :func:`fused_encode_plan` pick it)."""
    _check_cuda(xb, "fused_encode")
    if xb.dtype not in (torch.float32, torch.bfloat16):
        xb = xb.to(torch.float32)
    xb = xb.contiguous()
    bsz, n = xb.shape
    in_bf16 = xb.dtype == torch.bfloat16
    plan = fused_encode_plan(bsz, n, in_bf16,
                             fused_encode_resident(xb.device, in_bf16, bits),
                             variant)
    out_n = wire_len(n, bits)
    dev = xb.device
    # One float32 buffer: mn (B,), mx (B,), then the grid's (B * blocks)
    # (min, max) pairs.
    grid_pairs = bsz * plan.blocks if plan.variant == "grid" else 0
    ranges = torch.empty((2 * bsz + 2 * grid_pairs,), dtype=torch.float32,
                         device=dev)
    mn, mx, pairs = ranges[:bsz], ranges[bsz:2 * bsz], ranges[2 * bsz:]
    codes = torch.empty((bsz, out_n), dtype=code_dtype(bits), device=dev)
    fn = _fn("quantize", "jalad_fused_encode",
             [_P, _I, _I, _L, _I, _I, _I, _L, _I, _P, _P, _P, _P, _L, _P])
    status = fn(_ptr(xb), int(in_bf16), bsz, n, bits,
                FE_VARIANTS.index(plan.variant), plan.blocks,
                plan.stage_elems, plan.smem_bytes, _ptr(pairs), _ptr(mn),
                _ptr(mx), _ptr(codes), out_n, _stream())
    build.check(status, "fused_encode")
    bump("fused_encode")
    return codes, mn, mx


def _check_ranges(what: str, ref: torch.Tensor, shape, *ranges) -> None:
    """Raise unless each range tensor has ``shape`` and lies on ``ref``'s
    device: the kernels read them through pointers."""
    for r in ranges:
        if tuple(r.shape) != tuple(shape) or r.device != ref.device:
            raise ValueError(f"{what}: ranges must be {tuple(shape)} on "
                             f"{ref.device}, got {tuple(r.shape)} on "
                             f"{r.device}")


@kernel_span("fused_decode",
             lambda out, codes, *_, **__: tensor_bytes(codes, out)
             + 8 * out.shape[0])
def fused_decode(codes: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                 bits: int, n: int, packed: bool,
                 out_dtype=torch.float32) -> torch.Tensor:
    """K2 on a (B, W) code stack: (B, n) ``out_dtype`` activations. The
    step is :func:`repro_torch.core.quantization.dequant_step` in float32,
    as the reference computes it; the kernel computes it itself from
    ``mn``, ``mx`` and :func:`dequant_recip`, so a CUDA call is one
    launch."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    mn = mn.to(torch.float32)
    mx = mx.to(torch.float32)
    if codes.device.type == "cpu":
        return ref.fused_decode_ref(codes, mn, dequant_step(mn, mx, bits), n,
                                    packed, out_dtype)
    _check_cuda(codes, "fused_decode")
    want = torch.uint8 if packed else code_dtype(bits)
    if codes.dtype != want:
        raise ValueError(f"fused_decode: codes must be {want} at {bits} "
                         f"bits, got {codes.dtype}")
    codes = codes.contiguous()
    bsz, in_n = codes.shape
    if in_n < (-(-n // 2) if packed else n):
        raise ValueError(f"fused_decode: {in_n} codes per sample cannot "
                         f"hold {n} elements")
    mn = mn.reshape(-1).contiguous()
    mx = mx.reshape(-1).contiguous()
    _check_ranges("fused_decode", codes, (bsz,), mn, mx)
    out = torch.empty((bsz, n), dtype=out_dtype, device=codes.device)
    mode = 0 if packed else (1 if bits <= 8 else 2)
    fn = _fn("quantize", "jalad_fused_decode",
             [_P, _I, _I, _L, _L, _P, _P, _F, _P, _I, _I, _P])
    status = fn(_ptr(codes), mode, bsz, in_n, n, _ptr(mn), _ptr(mx),
                dequant_recip(bits), _ptr(out),
                int(out_dtype == torch.bfloat16), _GRID_TARGET, _stream())
    build.check(status, "fused_decode")
    bump("fused_decode")
    return out


# ---------------------------------------------------------------------------
# Edge encode
# ---------------------------------------------------------------------------


def quantize_pack_batch(xb: torch.Tensor, bits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A (B, *shape) stack -> (codes (B, wire_len), mn (B,), mx (B,)), one
    encode for the whole stack with per-sample ranges; each sample's codes
    are byte-identical to encoding it alone."""
    bsz = xb.shape[0]
    n = int(np.prod(xb.shape[1:])) if xb.ndim > 1 else 1
    if n == 0:
        zeros = torch.zeros((bsz,), dtype=torch.float32, device=xb.device)
        return (torch.empty((bsz, 0), dtype=code_dtype(bits),
                            device=xb.device), zeros, zeros.clone())
    return fused_encode(xb.reshape(bsz, n), bits)


def quantize_pack(x: torch.Tensor, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor -> (flat wire codes, mn, mx) as 0-d tensors."""
    codes, mn, mx = quantize_pack_batch(x.reshape(1, -1), bits)
    return codes[0], mn[0], mx[0]


def quantize_pack_stack(xs: Sequence[torch.Tensor], bits: int):
    """:func:`quantize_pack_batch` over a sequence of same-shape tensors."""
    return quantize_pack_batch(torch.stack(list(xs)), bits)


# ---------------------------------------------------------------------------
# Cloud decode
# ---------------------------------------------------------------------------


def _ranges(v, shape, device) -> torch.Tensor:
    """Range header(s) ``v`` (tensor or numpy) as a float32 tensor of
    ``shape`` on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(shape)
    return torch.as_tensor(np.array(v, np.float32).reshape(shape),
                           device=device)


def _decode(codes2: torch.Tensor, mn, mx, bits: int, shape, packed: bool,
            out_dtype) -> torch.Tensor:
    bsz = codes2.shape[0]
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n == 0:
        return torch.zeros((bsz,) + shape, dtype=out_dtype,
                           device=codes2.device)
    out = fused_decode(codes2, _ranges(mn, bsz, codes2.device),
                       _ranges(mx, bsz, codes2.device), bits, n, packed,
                       out_dtype)
    return out.reshape((bsz,) + shape)


def dequantize_wire_batch(codes_flat: torch.Tensor, mn, mx, bits: int,
                          shape, out_dtype=torch.float32) -> torch.Tensor:
    """(B, wire_len) bitpack wire codes + (B,) ranges -> (B, *shape)."""
    return _decode(codes_flat.reshape(codes_flat.shape[0], -1), mn, mx, bits,
                   shape, bits <= 4, out_dtype)


def dequantize_wire(codes_flat: torch.Tensor, mn, mx, bits: int, shape,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Cloud decode of one tensor's bitpack wire codes."""
    return dequantize_wire_batch(codes_flat.reshape(1, -1), mn, mx, bits,
                                 shape, out_dtype)[0]


def dequantize_unpack(codes: torch.Tensor, mn, mx, bits: int, shape,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`; ``shape`` is the original
    tensor's shape. One K2 launch on the card: the nibble unpack (at 4
    bits or fewer), the affine dequantization and the cast to
    ``out_dtype``."""
    return dequantize_wire(codes, mn, mx, bits, shape, out_dtype)


def quantize_dequantize_kernel(x: torch.Tensor, bits: int) -> torch.Tensor:
    """One-call straight-through path (edge-side simulation): one K1 and
    one K2 launch on the card, ``x``'s shape and dtype back."""
    codes, mn, mx = quantize_pack(x, bits)
    return dequantize_unpack(codes, mn, mx, bits, tuple(x.shape),
                             out_dtype=x.dtype)


def dequantize_codes_batch(codes2: torch.Tensor, mn, mx, bits: int, shape,
                           out_dtype=torch.float32) -> torch.Tensor:
    """(B, n) unpacked integer codes (one per element at every width, e.g.
    from the Huffman decoder) + (B,) ranges -> (B, *shape)."""
    bsz = codes2.shape[0]
    codes2 = codes2.reshape(bsz, -1)
    if codes2.dtype != code_dtype(bits):
        codes2 = codes2.to(torch.int32).to(code_dtype(bits))
    return _decode(codes2, mn, mx, bits, shape, False, out_dtype)


def dequantize_codes(codes: torch.Tensor, mn, mx, bits: int, shape,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Cloud decode of one tensor's unpacked integer codes."""
    return dequantize_codes_batch(codes.reshape(1, -1), mn, mx, bits, shape,
                                  out_dtype)[0]


def _decode_sharded(decode, codes, mn, mx, bits: int, shape, mesh,
                    batch_axis: str, out_dtype):
    """``decode`` of this rank's rows of a (B, ...) stack, as a DTensor
    sharded on its batch dim over ``batch_axis`` and replicated over the
    mesh's other axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = list(mesh.mesh_dim_names)
    if batch_axis not in names:
        raise ValueError(f"mesh axes {tuple(names)} have no {batch_axis!r}")
    j = names.index(batch_axis)
    n = mesh.size(j)
    bsz = int(codes.shape[0])
    if bsz % n:
        raise ValueError(f"a batch of {bsz} does not split over the "
                         f"{n} ranks of {batch_axis!r}")
    per = bsz // n
    lo = mesh.get_coordinate()[j] * per
    rows = slice(lo, lo + per)
    local = codes[rows]
    if isinstance(local, np.ndarray):
        local = torch.from_numpy(np.ascontiguousarray(local))
    out = decode(local.to(mesh.device_type), mn[rows], mx[rows], bits,
                 shape, out_dtype)
    return DTensor.from_local(
        out, mesh, [Shard(0) if a == batch_axis else Replicate()
                    for a in names], run_check=False)


def dequantize_wire_batch_sharded(codes_flat, mn, mx, bits: int, shape, mesh,
                                  batch_axis: str = "data",
                                  out_dtype=torch.float32):
    """:func:`dequantize_wire_batch` straight into per-rank batch shards:
    every rank holds the (B, wire_len) codes and (B,) ranges (numpy or
    tensors), decodes only its own rows (one K2 launch on the card) and
    returns its part of the (B, *shape) DTensor, sharded over
    ``batch_axis``. Each sample decodes byte-identically to decoding it
    alone. B must split evenly over ``batch_axis``: the meshed cloud
    worker pads the group to a multiple first."""
    return _decode_sharded(dequantize_wire_batch, codes_flat, mn, mx, bits,
                           shape, mesh, batch_axis, out_dtype)


def dequantize_codes_batch_sharded(codes2, mn, mx, bits: int, shape, mesh,
                                   batch_axis: str = "data",
                                   out_dtype=torch.float32):
    """:func:`dequantize_codes_batch` (one unpacked code an element, e.g.
    the host Huffman decoder's output) into per-rank batch shards, as
    :func:`dequantize_wire_batch_sharded`."""
    return _decode_sharded(dequantize_codes_batch, codes2, mn, mx, bits,
                           shape, mesh, batch_axis, out_dtype)


# ---------------------------------------------------------------------------
# Per-channel codec: K4 encode, K5 decode
# ---------------------------------------------------------------------------


# K4: a cluster of blocks per (sample, channel) (``csrc/perchannel.cu``).
# The host picks the cluster size (1 to the portable maximum of 8) that
# brings B * C * cluster to about _PC_FILL_BLOCKS (132 SMs x 4) while each
# block keeps at least PC_MIN_SHARE elements, and splits the channel's W
# words into ``cluster`` contiguous shares; a cluster of 1 is a plain
# launch. A block stages
# its share (at most PC_SHARE_MAX_FLOATS floats, under 112 KiB with the
# layout's spare floats, so two blocks fit an SM) in shared memory; a channel longer than a cluster of 8 such
# shares takes the streaming variant, which re-reads its share from L2 for
# the pack in tiles of at most PC_STREAM_TILE floats.
PC_MAX_CLUSTER = 8
_PC_FILL_BLOCKS = 528
PC_MIN_SHARE = 2048
PC_SHARE_MAX_FLOATS = 27_648
PC_STREAM_TILE = 8192
_PC_THREADS = 256


@dataclass(frozen=True)
class PcEncodePlan:
    """K4's launch: ``cluster`` blocks a channel of ``threads`` threads,
    ``staged`` or streaming in tiles of ``tile_words`` words, and the
    dynamic shared memory of a block."""
    cluster: int
    staged: bool
    threads: int
    tile_words: int
    smem_bytes: int


def pc_shares(n_words: int, cluster: int):
    """The words ``[w0, w1)`` each rank of a channel's cluster packs; the
    kernel splits the same way."""
    return [(r * n_words // cluster, (r + 1) * n_words // cluster)
            for r in range(cluster)]


def _pc_smem_floats(elems: int) -> int:
    """Shared floats that hold a tile of ``elems`` floats: the 32-float
    lead (the 16-byte loads start up to three floats early) and three
    floats past the end, one spare float every 32."""
    a = elems + 32 + 3
    return a + a // 32 + 1


def pc_encode_plan(bsz: int, channels: int, length: int, bits: int,
                   staged: Optional[bool] = None,
                   cluster: Optional[int] = None) -> PcEncodePlan:
    """K4's launch for (B, C) channels of ``length`` elements at ``bits``;
    ``staged`` forces a variant and ``cluster`` a cluster size (None picks
    each by size)."""
    per_word = 32 // bits
    n_words = perchannel_words(length, bits)
    need = -(-n_words // (PC_SHARE_MAX_FLOATS // per_word))
    if staged is None:
        staged = need <= PC_MAX_CLUSTER
    if cluster is None:
        cluster = min(PC_MAX_CLUSTER, n_words,
                      max(1, _PC_FILL_BLOCKS // (bsz * channels)),
                      max(1, length // PC_MIN_SHARE))
        if staged:
            cluster = max(cluster, need)
    if not 1 <= cluster <= min(PC_MAX_CLUSTER, n_words) or (
            staged and cluster < need):
        raise ValueError(f"pc_encode: no cluster of {cluster} blocks "
                         f"{'stages' if staged else 'streams'} a channel "
                         f"of {length} elements at {bits} bits")
    if staged:
        tile_words = -(-n_words // cluster)
        share = tile_words * per_word
        threads = min(_PC_THREADS, max(32, -(-share // 256) * 32))
    else:
        threads = _PC_THREADS
        tile_words = PC_STREAM_TILE // per_word
        share = tile_words * per_word
    return PcEncodePlan(cluster, staged, threads, tile_words,
                        4 * _pc_smem_floats(share))


@kernel_span("pc_encode", lambda out, xb, *_: tensor_bytes(xb, *out))
def pc_encode(xb: torch.Tensor, bits: int, axis: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on a (B, *shape) stack with the channel on ``axis`` of the
    sample shape: (words (B, C, W) int32, mn (B, C), mx (B, C))."""
    _check_bits(bits)
    if xb.device.type == "cpu":
        return ref.pc_encode_ref(xb, bits, axis)
    return _pc_encode_cuda(xb, bits, axis, None)


def _pc_encode_cuda(xb: torch.Tensor, bits: int, axis: int,
                    staged: Optional[bool], cluster: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's launch; ``staged`` and ``cluster`` force the variant and the
    cluster size (``pc_encode`` lets :func:`pc_encode_plan` pick both)."""
    _check_cuda(xb, "pc_encode")
    bsz = xb.shape[0]
    outer, c, inner = channel_dims(xb.shape[1:], axis)
    length = outer * inner
    if length == 0 or c == 0 or length * c >= 1 << 31:
        raise ValueError(f"pc_encode: channel length {length} x {c} "
                         "channels must be in [1, 2^31)")
    xb = xb.to(torch.float32).contiguous()
    n_words = perchannel_words(length, bits)
    plan = pc_encode_plan(bsz, c, length, bits, staged, cluster)
    dev = xb.device
    words = torch.empty((bsz, c, n_words), dtype=torch.int32, device=dev)
    mn = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    mx = torch.empty_like(mn)
    fn = _fn("perchannel", "jalad_pc_encode",
             [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              _P])
    status = fn(_ptr(xb), bsz, outer, c, inner, bits, _ptr(mn), _ptr(mx),
                _ptr(words), n_words, plan.threads, plan.cluster,
                int(plan.staged), plan.tile_words, plan.smem_bytes,
                _stream())
    build.check(status, "pc_encode")
    bump("pc_encode")
    return words, mn, mx


# K5 stages its words in shared memory (the tiled variant) where a
# channel's output runs hold at least this many contiguous elements, and
# decodes one element a thread below it: the crossover that
# ``chip_smoke.py`` measures with both variants on (4, 2048, inner)
# samples lay between inner = 49 and 64 on the H100.
PC_TILE_MIN_INNER = 64


@kernel_span("pc_decode",
             lambda out, words, mn, *_, **__: tensor_bytes(words, out)
             + 8 * mn.numel())
def pc_decode(words: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
              bits: int, shape, axis: int,
              out_dtype=torch.float32) -> torch.Tensor:
    """K5: (B, C, W) words + (B, C) ranges -> (B, *shape) ``out_dtype``.
    The step is :func:`repro_torch.core.quantization.dequant_step` per
    channel, as the reference computes it; the kernel computes it itself,
    so a CUDA call is one launch."""
    _check_bits(bits)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    shape = tuple(int(s) for s in shape)
    if words.device.type == "cpu":
        return ref.pc_decode_ref(words, mn, mx, bits, shape, axis, out_dtype)
    inner = channel_dims(shape, axis)[2]
    return _pc_decode_cuda(words, mn, mx, bits, shape, axis, out_dtype,
                           inner >= PC_TILE_MIN_INNER)


def _pc_decode_cuda(words: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                    bits: int, shape, axis: int, out_dtype,
                    tiled: bool) -> torch.Tensor:
    """K5's launch, with the variant given (``pc_decode`` picks it)."""
    _check_cuda(words, "pc_decode")
    bsz, c, n_words = words.shape
    outer, c_shape, inner = channel_dims(shape, axis)
    n = outer * c * inner
    if (words.dtype != torch.int32 or c_shape != c
            or n_words != perchannel_words(outer * inner, bits)
            or n == 0 or n >= 1 << 31):
        raise ValueError(f"pc_decode: words {tuple(words.shape)} "
                         f"{words.dtype} do not match shape {shape} at "
                         f"{bits} bits")
    words = words.contiguous()
    mn = mn.to(torch.float32).contiguous()
    mx = mx.to(torch.float32).contiguous()
    _check_ranges("pc_decode", words, (bsz, c), mn, mx)
    out = torch.empty((bsz,) + shape, dtype=out_dtype, device=words.device)
    fn = _fn("perchannel", "jalad_pc_decode",
             [_P, _I, _I, _I, _I, _I, _I, _P, _P, _F, _P, _I, _I, _I, _P])
    status = fn(_ptr(words), bsz, outer, c, inner, bits, n_words, _ptr(mn),
                _ptr(mx), dequant_recip(bits), _ptr(out),
                int(out_dtype == torch.bfloat16), int(tiled), _GRID_TARGET,
                _stream())
    build.check(status, "pc_decode")
    bump("pc_decode")
    return out


# The per-channel edge encode of a (B, *shape) stack is one K4 launch; each
# sample's words and ranges are identical to encoding it alone.
perchannel_encode_batch = pc_encode


def perchannel_encode_stack(xs: Sequence[torch.Tensor], bits: int,
                            axis: int):
    """:func:`perchannel_encode_batch` over a sequence of same-shape
    tensors."""
    return perchannel_encode_batch(torch.stack(list(xs)), bits, axis)


def perchannel_encode(x: torch.Tensor, bits: int, axis: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor -> (words (C, W), mn (C,), mx (C,))."""
    words, mn, mx = perchannel_encode_batch(x[None], bits, axis)
    return words[0], mn[0], mx[0]


def perchannel_decode_batch(words3: torch.Tensor, mn2, mx2, bits: int,
                            shape, axis: int,
                            out_dtype=torch.float32) -> torch.Tensor:
    """Cloud half, batched: (B, C, W) words + (B, C) ranges -> (B, *shape)
    in one K5 launch."""
    bc, dev = words3.shape[:2], words3.device
    return pc_decode(words3, _ranges(mn2, bc, dev), _ranges(mx2, bc, dev),
                     bits, shape, axis, out_dtype)


def perchannel_decode(words2: torch.Tensor, mn, mx, bits: int, shape,
                      axis: int, out_dtype=torch.float32) -> torch.Tensor:
    """Single-tensor per-channel decode."""
    return perchannel_decode_batch(words2[None], mn, mx, bits, shape, axis,
                                   out_dtype)[0]


# ---------------------------------------------------------------------------
# Three-launch encode chain: K6a, K6b, K6c
# ---------------------------------------------------------------------------


def _flat_input(x: torch.Tensor, what: str) -> torch.Tensor:
    """A non-empty float32 / bfloat16 CUDA tensor, flat and contiguous."""
    _check_cuda(x, what)
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    return x.reshape(-1).contiguous()


def _vectors(xf: torch.Tensor) -> int:
    """16-byte loads that cover the flat input ``xf``."""
    return -(-xf.numel() * xf.element_size() // 16)


# K6a reads an input of at most this many bytes with one block and a plain
# launch (two rounds of its loads): a cooperative launch costs ~1 us more
# on the H100 (18 KB: 7.9 against 6.9 us cold), which one block's loads
# outrun only above this.
K6A_SOLO_BYTES = 32 << 10


@functools.lru_cache(maxsize=None)
def _minmax_resident(device_index: int, in_bf16: bool) -> int:
    """Blocks of K6a's cooperative grid on the card: those it holds at
    once, at most two an SM."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        fn = _fn("threelaunch", "jalad_minmax_resident",
                 [_I, ctypes.POINTER(ctypes.c_int)])
        build.check(fn(int(in_bf16), ctypes.byref(out)),
                    "minmax_blocks occupancy")
    return out.value


@kernel_span("minmax_blocks", lambda out, x: tensor_bytes(x, *out))
def minmax_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a: a tensor of n >= 1 elements -> its ``(mn, mx)``, two 0-d
    float32 tensors on its device, in the reference's order (``-0.0 <
    +0.0``), as the reference's ``minmax_blocks`` returns them. One launch
    that folds every block's range itself: one block up to
    ``K6A_SOLO_BYTES``, a cooperative grid above."""
    if x.device.type == "cpu":
        return ref.minmax_blocks_ref(x)
    xf = _flat_input(x, "minmax_blocks")
    in_bf16 = xf.dtype == torch.bfloat16
    vectors = _vectors(xf)
    if 16 * vectors <= K6A_SOLO_BYTES:
        blocks = 1
    else:
        index = (xf.device.index if xf.device.index is not None
                 else torch.cuda.current_device())
        blocks = min(_grid(vectors, 1), _minmax_resident(index, in_bf16))
    partials = torch.empty((blocks, 2), dtype=torch.int32, device=xf.device)
    out = torch.empty((2,), dtype=torch.float32, device=xf.device)
    fn = _fn("threelaunch", "jalad_minmax_blocks",
             [_P, _I, _L, _I, _P, _P, _P])
    status = fn(_ptr(xf), int(in_bf16), xf.numel(), blocks, _ptr(partials),
                _ptr(out), _stream())
    build.check(status, "minmax_blocks")
    bump("minmax_blocks")
    return out[0], out[1]


@kernel_span("quantize_blocks", lambda out, x, *_: tensor_bytes(x, out) + 8)
def quantize_blocks(x: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """K6b: a tensor of n >= 1 elements + its 0-d float32 ``(mn, mx)`` on
    its device -> (n,) codes ``clip(round((x - mn) * scale), 0, 2^c -
    1)``, u8 at bits <= 8, u16 above, with the reference's ``scale =
    (2^c - 1) / (mx - mn)`` (0 where ``mx == mn``) taken in the kernel. The
    kernel reads ``mn`` and ``mx`` through pointers: no host sync."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_blocks_ref(x, mn, mx, bits)
    xf = _flat_input(x, "quantize_blocks")
    mn = mn.to(torch.float32).reshape(())
    mx = mx.to(torch.float32).reshape(())
    if mn.device != xf.device or mx.device != xf.device:
        raise ValueError("quantize_blocks: mn and mx must lie on the "
                         "input's device")
    n = xf.numel()
    codes = torch.empty((n,), dtype=code_dtype(bits), device=xf.device)
    fn = _fn("threelaunch", "jalad_quantize_blocks",
             [_P, _I, _L, _P, _P, _I, _P, _I, _P])
    status = fn(_ptr(xf), int(xf.dtype == torch.bfloat16), n, _ptr(mn),
                _ptr(mx), bits, _ptr(codes), _grid(_vectors(xf), 1),
                _stream())
    build.check(status, "quantize_blocks")
    bump("quantize_blocks")
    return codes


@kernel_span("pack4_blocks", lambda out, codes: tensor_bytes(codes, out))
def pack4_blocks(codes: torch.Tensor) -> torch.Tensor:
    """K6c: (n,) u8 codes, n >= 1 -> (ceil(n / 2),) packed bytes ``codes[2i]
    | codes[2i + 1] << 4`` truncated to 8 bits (so codes of 16 and above
    give the plain version's bytes too). 16-byte loads where the codes start
    on a 16-byte boundary, one byte a thread where they do not."""
    if codes.device.type == "cpu":
        return ref.pack4_blocks_ref(codes)
    _check_cuda(codes, "pack4_blocks")
    if codes.dtype != torch.uint8 or codes.numel() == 0:
        raise ValueError(f"pack4_blocks: expected non-empty uint8 codes, "
                         f"got {codes.dtype} x {codes.numel()}")
    codes = codes.reshape(-1).contiguous()
    n = codes.numel()
    out_n = (n + 1) // 2
    out = torch.empty((out_n,), dtype=torch.uint8, device=codes.device)
    fn = _fn("threelaunch", "jalad_pack4_blocks", [_P, _L, _P, _L, _I, _P])
    status = fn(_ptr(codes), n, _ptr(out), out_n, _grid(-(-n // 16), 1),
                _stream())
    build.check(status, "pack4_blocks")
    bump("pack4_blocks")
    return out


def quantize_pack_threelaunch(x: torch.Tensor, bits: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The three-launch edge encode: K6a the range, K6b quantize, then K6c
    pack at bits <= 4, the codes making a round trip through device memory
    in between; nothing else runs on the device but the allocations.
    Returns ``(flat wire codes, mn, mx)``, byte-identical to
    :func:`quantize_pack` (K1); 3 launches at bits <= 4, 2 above."""
    _check_bits(bits)
    if x.numel() == 0:
        return quantize_pack(x, bits)
    mn, mx = minmax_blocks(x)
    codes = quantize_blocks(x, mn, mx, bits)
    if bits <= 4:
        codes = pack4_blocks(codes)
    return codes, mn, mx
