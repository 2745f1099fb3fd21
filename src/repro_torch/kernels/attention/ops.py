"""The int8 KV cache's decode step: K7a (append) and K7b (attend).

:func:`kv8_decode` is one attention decode step of a block whose KV cache
is int8 codes with float32 scales (``cfg.kv_cache_bits == 8``): the new
key and value rows quantized into the cache at each live row's position,
then the queries' attention over each row's valid slots. It follows the
dispatch rule of every kernel wrapper of the port
(:mod:`repro_torch.kernels.quantize.ops`): a CPU tensor runs the plain
version, :func:`kv8_decode_plain`; a CUDA tensor launches the kernels of
``csrc/kv8_attention.cu`` or raises; any other device raises. There is no
fallback from one to the other.

The plain version dequantizes the whole cache to the query's dtype every
step; the kernels read only the codes and scales of each row's valid
slots and widen them in registers (see the CUDA source for the numerics).
The codes, the scales and so the cache contents are the plain version's
bit for bit; the output is the plain version's within bf16 rounding.

Launch counters: ``kv8_append`` one a call (one kernel), ``kv8_attend``
one a call (two kernels: the splits, then their combine).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.counters import bump
from repro_torch.models.layers import attention as attn_lib

# Positions a split of K7b (``kSplit`` in csrc/kv8_attention.cu).
KV8_SPLIT = 256
# The widest head dim the kernels take (``kMaxHd``).
KV8_MAX_HEAD_DIM = 256

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_DTYPES = (torch.bfloat16, torch.float32)


def kv8_decode_plain(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: torch.Tensor,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: quantize the step's rows, write them at each
    row's ``pos`` (rows whose ``live`` flag is off keep theirs), dequantize
    the whole cache and attend over each row's first ``pos + 1`` slots.
    Also takes sharded (DTensor) and meta or fake caches."""
    qk, ks_new = attn_lib.quantize_kv_row(k_new)
    qv, vs_new = attn_lib.quantize_kv_row(v_new)
    k_c, v_c = attn_lib.cache_update(cache["k"], cache["v"], qk, qv, pos,
                                     live)
    ks_c = attn_lib.scale_update(cache["ks"], ks_new, pos, live)
    vs_c = attn_lib.scale_update(cache["vs"], vs_new, pos, live)
    k_use = attn_lib.dequantize_kv(k_c, ks_c, q.dtype)
    v_use = attn_lib.dequantize_kv(v_c, vs_c, q.dtype)
    return attn_lib.decode_attention(q, k_use, v_use, pos + 1)


@functools.lru_cache(maxsize=None)
def _fn(name: str, argtypes: tuple):
    fn = getattr(build.load("kv8_attention"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _vec(hd: int, *tensors: torch.Tensor) -> int:
    """Codes a load: the widest of 16, 8, 4, 2, 1 bytes that divides the
    head dim and every cache's address."""
    for v in (16, 8, 4, 2):
        if hd % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


def _fail(what: str) -> None:
    raise ValueError(f"kv8_decode: {what}")


def _check(q, k_new, v_new, cache, pos, live) -> None:
    if q.device.type != "cuda":
        _fail(f"expected a CPU or CUDA tensor, got {q.device}")
    if q.dim() != 4 or q.shape[1] != 1:
        _fail(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    kc = cache["k"]
    if kc.dim() != 4 or kc.shape[0] != b or kc.shape[3] != hd:
        _fail(f"cache k {tuple(kc.shape)} does not fit q {tuple(q.shape)}")
    kv_shape = tuple(kc.shape[1:3])
    kv = kv_shape[1]
    if q.dtype not in _DTYPES or hd > KV8_MAX_HEAD_DIM or kv == 0 \
            or h % kv:
        _fail(f"takes bf16 or f32 queries, head dims up to "
              f"{KV8_MAX_HEAD_DIM} and heads a multiple of the kv heads; "
              f"got {q.dtype}, hd {hd}, {h} heads over {kv}")
    want = {"k": ((b, *kv_shape, hd), torch.int8),
            "v": ((b, *kv_shape, hd), torch.int8),
            "ks": ((b, *kv_shape), torch.float32),
            "vs": ((b, *kv_shape), torch.float32)}
    for key, (shape, dtype) in want.items():
        t = cache[key]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != q.device:
            _fail(f"cache {key} must be a contiguous {dtype} {shape} on "
                  f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        shape = (b, 1, h if name == "q" else kv, hd)
        if tuple(t.shape) != shape or t.dtype != q.dtype \
                or not t.is_contiguous() or t.device != q.device:
            _fail(f"{name} must be a contiguous {q.dtype} {shape} on "
                  f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if pos.shape != (b,) or pos.dtype != torch.int64 \
            or pos.device != q.device or pos.stride(0) not in (0, 1):
        _fail(f"pos must be a (B,) int64 on {q.device} with stride 0 or 1")
    if live is not None and (live.shape != (b,) or live.dtype != torch.bool
                             or not live.is_contiguous()
                             or live.device != q.device):
        _fail(f"live must be None or a contiguous (B,) bool on {q.device}")


def kv8_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over an int8 KV cache, in place.

    q: (B, 1, H, hd); k_new, v_new: (B, 1, kv, hd), post-RoPE, q's dtype;
    cache: ``{"k", "v"}`` (B, S_c, kv, hd) int8 and ``{"ks", "vs"}`` (B,
    S_c, kv) float32 (a ring buffer where S_c is a window); pos: (B,)
    int64, each row's new position; live: (B,) bool or None (every row).
    Writes each live row's new K/V codes and scales at slot ``pos % S_c``
    and returns the (B, 1, H, hd) attention output in q's dtype over each
    row's first ``min(pos + 1, S_c)`` slots. On the card: K7a, then K7b."""
    if q.device.type == "cpu":
        return kv8_decode_plain(q, k_new, v_new, cache, pos, live)
    _check(q, k_new, v_new, cache, pos, live)
    b, _, h, hd = q.shape
    s_c, kv = cache["k"].shape[1], cache["k"].shape[2]
    bf16 = int(q.dtype == torch.bfloat16)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    status = _fn("jalad_kv8_append", (_P, _P, _I, _P, _P, _P, _P, _P, _L, _P,
                                      _I, _I, _I, _I, _P))(
        _ptr(k_new), _ptr(v_new), bf16, _ptr(cache["k"]), _ptr(cache["ks"]),
        _ptr(cache["v"]), _ptr(cache["vs"]), _ptr(pos), pos.stride(0),
        _ptr(live), b, kv, s_c, hd, stream)
    build.check(status, "kv8_append")
    bump("kv8_append")
    n_split = -(-s_c // KV8_SPLIT)
    part = torch.empty(b * h * n_split * (hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    status = _fn("jalad_kv8_attend", (_P, _I, _P, _P, _P, _P, _P, _L, _I, _I,
                                      _I, _I, _I, _I, _F, _P, _I, _P, _P))(
        _ptr(q), bf16, _ptr(cache["k"]), _ptr(cache["ks"]), _ptr(cache["v"]),
        _ptr(cache["vs"]), _ptr(pos), pos.stride(0), b, h, kv, s_c, hd,
        _vec(hd, cache["k"], cache["v"]), _inv_sqrt(hd), _ptr(part), n_split,
        _ptr(out), stream)
    build.check(status, "kv8_attend")
    bump("kv8_attend")
    return out


def _inv_sqrt(hd: int) -> float:
    """The plain route's score scale ``hd ** -0.5`` as the float32 it
    multiplies by."""
    return float(np.float32(hd ** -0.5))
