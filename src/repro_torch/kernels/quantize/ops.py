"""Public wrappers of the quantize kernels K1 (encode) and K2 (decode).

Dispatch rule, the same for every kernel wrapper of the port: a CPU tensor
runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor launches the
hand-written kernel of ``csrc/quantize.cu`` or raises. There is no
fallback from one to the other.

Codes are the flat *wire* layout, per sample: two codes per byte for
bits <= 4 (``(n + 1) // 2`` bytes), one u8 per element for bits <= 8, one
u16 per element above. These are exactly the bytes the reference's bitpack
codec ships after trimming its TPU tile padding.

``ENCODE_LAUNCHES`` / ``DECODE_LAUNCHES`` count CUDA kernel launches (K1
is two launches: range reduction, then quantize + pack).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import dequant_step
from repro_torch.kernels import build
from repro_torch.kernels.quantize import ref
from repro_torch.kernels.quantize.ref import code_dtype, wire_len

ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0

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


def _fn(name: str, argtypes):
    fn = getattr(build.load("quantize"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")


def fused_encode(xb: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on a (B, n) stack, n >= 1: (codes (B, wire_len), mn (B,), mx (B,))."""
    global ENCODE_LAUNCHES
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    if xb.device.type == "cpu":
        return ref.fused_encode_ref(xb, bits)
    _check_cuda(xb, "fused_encode")
    if xb.dtype not in (torch.float32, torch.bfloat16):
        xb = xb.to(torch.float32)
    xb = xb.contiguous()
    bsz, n = xb.shape
    out_n = wire_len(n, bits)
    parts = _grid(n, bsz)
    blocks = _grid(out_n, bsz)
    dev = xb.device
    pmin = torch.empty((bsz, parts), dtype=torch.float32, device=dev)
    pmax = torch.empty_like(pmin)
    mn = torch.empty((bsz,), dtype=torch.float32, device=dev)
    mx = torch.empty_like(mn)
    codes = torch.empty((bsz, out_n), dtype=code_dtype(bits), device=dev)
    fn = _fn("jalad_fused_encode",
             [_P, _I, _I, _L, _I, _P, _P, _I, _I, _P, _P, _P, _L, _P])
    status = fn(_ptr(xb), int(xb.dtype == torch.bfloat16), bsz, n, bits,
                _ptr(pmin), _ptr(pmax), parts, blocks, _ptr(mn), _ptr(mx),
                _ptr(codes), out_n, _stream())
    build.check(status, "fused_encode")
    ENCODE_LAUNCHES += 2
    return codes, mn, mx


def fused_decode(codes: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                 bits: int, n: int, packed: bool,
                 out_dtype=torch.float32) -> torch.Tensor:
    """K2 on a (B, W) code stack: (B, n) ``out_dtype`` activations. The
    step is computed here in float32, outside the kernel, as the reference
    does (:func:`repro_torch.core.quantization.dequant_step`)."""
    global DECODE_LAUNCHES
    mn = mn.to(torch.float32)
    step = dequant_step(mn, mx.to(torch.float32), bits)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if codes.device.type == "cpu":
        return ref.fused_decode_ref(codes, mn, step, n, packed, out_dtype)
    _check_cuda(codes, "fused_decode")
    want = torch.uint8 if packed else code_dtype(bits)
    if codes.dtype != want:
        raise ValueError(f"fused_decode: codes must be {want} at {bits} "
                         f"bits, got {codes.dtype}")
    codes = codes.contiguous()
    mn = mn.contiguous()
    step = step.contiguous()
    bsz, in_n = codes.shape
    if in_n < (-(-n // 2) if packed else n) or mn.numel() != bsz:
        raise ValueError(f"fused_decode: {in_n} codes per sample cannot "
                         f"hold {n} elements, or ranges are not ({bsz},)")
    out = torch.empty((bsz, n), dtype=out_dtype, device=codes.device)
    mode = 0 if packed else (1 if bits <= 8 else 2)
    fn = _fn("jalad_fused_decode",
             [_P, _I, _I, _L, _L, _P, _P, _P, _I, _I, _P])
    status = fn(_ptr(codes), mode, bsz, in_n, n, _ptr(mn), _ptr(step),
                _ptr(out), int(out_dtype == torch.bfloat16),
                _grid(n, bsz), _stream())
    build.check(status, "fused_decode")
    DECODE_LAUNCHES += 1
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


def _ranges(v, bsz: int, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(bsz)
    return torch.as_tensor(np.asarray(v, np.float32).reshape(bsz),
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


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.entropy import ops as eops

    return {"fused_encode": ENCODE_LAUNCHES,
            "fused_decode": DECODE_LAUNCHES,
            "huffman_pack": eops.PACK_LAUNCHES,
            "huffman_host_route": eops.HOST_ROUTES}


def reset_launch_counts() -> None:
    global ENCODE_LAUNCHES, DECODE_LAUNCHES
    from repro_torch.kernels.entropy import ops as eops

    ENCODE_LAUNCHES = DECODE_LAUNCHES = 0
    eops.PACK_LAUNCHES = eops.HOST_ROUTES = 0


@contextlib.contextmanager
def count_launches():
    """Counts of kernel launches (and host Huffman routes) made inside the
    block: ``box.counts`` maps each counter to its increase."""

    class _Box:
        counts: Dict[str, int] = {}

    box = _Box()
    start = launch_counts()
    try:
        yield box
    finally:
        end = launch_counts()
        box.counts = {k: end[k] - start[k] for k in end}
