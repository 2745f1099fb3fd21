// Boundary-codec quantize kernels for Hopper (sm_90a): K1 and K2.
//
// K1  fused encode  — replaces repro/kernels/quantize/quantize.py
//     `fused_encode_blocks` (Pallas `_fused_encode_whole_kernel` /
//     `_fused_encode_kernel`). Per-sample min/max, then
//     q = clip(rint((x - mn) * scale), 0, 2^c - 1), scale = (2^c-1)/(mx-mn)
//     (0 when mx == mn), then nibble pairs lo | hi << 4 (c <= 4), u8 codes
//     (c <= 8) or u16 codes (c > 8).
// K2  fused decode  — replaces `fused_decode_blocks` (`_fused_decode_kernel`):
//     optional nibble unpack, fmaf(code, step, mn) rounded once, cast to
//     f32 or bf16. step = (mx - mn) * f32(1 / (2^c - 1)) is computed in the
//     kernel from the ranges (the reference computes it outside its kernel,
//     as one fused XLA op; here that would be three more launches a call).
//
// Bound on this card: bytes. Both kernels do a handful of flops per byte
// (far below the H100's ~20 flop/byte float32 ridge), so the least time is
// (bytes in + bytes out) / 3.35 TB/s. K1 must know each sample's global range
// before it writes any code, and blocks on a GPU run in no order, so it is
// two launches: a grid-wide partial min/max reduction, then the quantize +
// pack pass, whose blocks each fold the (few hundred) partials of their
// sample before streaming the input a second time. The input is read twice
// (the TPU kernel also streams it twice); the codes are written once and
// never round-trip device memory between the affine map and the pack.
// Loads and stores are coalesced (neighbouring threads, neighbouring
// elements). K2 is one launch and one pass: every code byte read once,
// every output element written once, by vectors: a thread writes 16 bytes
// of output a store (four floats or eight bf16) from one load of the 2 to
// 16 bytes of codes they come from, four vectors a thread in flight, so a
// warp's store covers 512 contiguous bytes. (One 16-byte load of codes a
// thread, written as four strided float4 stores, ran slower warm: each
// store instruction touched 16 lines, not 4.) A row whose output does not
// start 16-byte aligned has a few scalar head and tail elements; where the
// codes of the aligned output are not aligned to the load (odd n with
// packed nibbles, rows of other lengths) the vector loads them one by one.
//
// Numerics: IEEE subtract, multiply and divide through the _rn intrinsics
// (never contracted, never fast-math) and rintf (round half to even, as
// jnp.round), so codes are bit-identical to the reference; the decode uses
// one fmaf so it rounds once, as the reference's jitted decode does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// Min and max over the block; every thread returns the block's result.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[32];
  __shared__ float s_hi[32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < n_warps ? s_lo[lane] : INFINITY;
    hi = lane < n_warps ? s_hi[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_lo[0] = lo;
      s_hi[0] = hi;
    }
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
}

__device__ __forceinline__ unsigned quant_code(float v, float mn, float scale,
                                               float levels) {
  float q = rintf(__fmul_rn(__fsub_rn(v, mn), scale));
  q = fminf(fmaxf(q, 0.0f), levels);
  return static_cast<unsigned>(q);
}

// K1, launch 1: grid (parts, B). Block (p, b) reduces a grid-stride share
// of sample b into partials[b * parts + p].
template <typename T>
__global__ void __launch_bounds__(kThreads)
minmax_partials_kernel(const T* __restrict__ x, long long n,
                       float* __restrict__ pmin, float* __restrict__ pmax) {
  const int b = blockIdx.y;
  const T* xs = x + static_cast<long long>(b) * n;
  float lo = INFINITY;
  float hi = -INFINITY;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float v = load_f32(xs, i);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    pmin[b * gridDim.x + blockIdx.x] = lo;
    pmax[b * gridDim.x + blockIdx.x] = hi;
  }
}

// K1, launch 2: grid (blocks, B). Each block folds sample b's partials,
// then quantizes (+ packs) a grid-stride share of the sample's outputs.
// MODE 0: two codes per byte (element 2j low nibble, 2j+1 high nibble; an
// odd count repeats element 0 in the last high nibble, as the reference's
// first-element tile padding does). MODE 1: u8 codes. MODE 2: u16 codes.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const T* __restrict__ x, long long n,
                     const float* __restrict__ pmin,
                     const float* __restrict__ pmax, int parts, float levels,
                     float* __restrict__ mn_out, float* __restrict__ mx_out,
                     void* __restrict__ out, long long out_n) {
  const int b = blockIdx.y;
  float lo = INFINITY;
  float hi = -INFINITY;
  for (int i = threadIdx.x; i < parts; i += blockDim.x) {
    lo = fminf(lo, pmin[b * parts + i]);
    hi = fmaxf(hi, pmax[b * parts + i]);
  }
  block_minmax(lo, hi);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    mn_out[b] = lo;
    mx_out[b] = hi;
  }
  const float scale = hi > lo ? __fdiv_rn(levels, __fsub_rn(hi, lo)) : 0.0f;
  const T* xs = x + static_cast<long long>(b) * n;
  const long long base = static_cast<long long>(b) * out_n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < out_n; j += stride) {
    if (MODE == 0) {
      const long long i1 = 2 * j + 1;
      const unsigned q0 = quant_code(load_f32(xs, 2 * j), lo, scale, levels);
      const unsigned q1 =
          quant_code(load_f32(xs, i1 < n ? i1 : 0), lo, scale, levels);
      static_cast<uint8_t*>(out)[base + j] =
          static_cast<uint8_t>(q0 | (q1 << 4));
    } else if (MODE == 1) {
      static_cast<uint8_t*>(out)[base + j] =
          static_cast<uint8_t>(quant_code(load_f32(xs, j), lo, scale, levels));
    } else {
      static_cast<uint16_t*>(out)[base + j] = static_cast<uint16_t>(
          quant_code(load_f32(xs, j), lo, scale, levels));
    }
  }
}

// Output elements before the first 16-byte-aligned one at p (p is aligned
// to its element size).
template <typename OutT>
__device__ __forceinline__ long long head_elems(const OutT* p) {
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)) &
                       15u;
  return static_cast<long long>(((16u - mis) & 15u) / sizeof(OutT));
}

__device__ __forceinline__ void store_out(float* p, long long i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, long long i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// 16 bytes of output to 16-byte-aligned p: four floats, or eight bf16
// (__float2bfloat16_rn each).
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                 bf16x2(v[6], v[7]));
}

// Code of element i of a sample whose codes start at element / byte row.
// MODE 0: nibble-packed u8 (element i in byte i >> 1, low nibble when i is
// even). MODE 1: u8 codes. MODE 2: u16 codes.
template <int MODE>
__device__ __forceinline__ unsigned code_at(const void* codes, long long row,
                                            long long i) {
  if (MODE == 0) {
    const uint8_t byte = static_cast<const uint8_t*>(codes)[row + (i >> 1)];
    return (i & 1) ? (byte >> 4) : (byte & 0x0Fu);
  } else if (MODE == 1) {
    return static_cast<const uint8_t*>(codes)[row + i];
  } else {
    return static_cast<const uint16_t*>(codes)[row + i];
  }
}

// One vector of K2: the kOut elements of one 16-byte output store and the
// kBytes of codes they come from (2, 4, 8 or 16 bytes), kPer codes of kBits
// to a 32-bit word.
template <int MODE, typename OutT>
struct DecodeVec {
  static constexpr int kOut = 16 / sizeof(OutT);
  static constexpr int kBits = MODE == 0 ? 4 : (MODE == 1 ? 8 : 16);
  static constexpr int kPer = 32 / kBits;
  static constexpr int kBytes = kOut * kBits / 8;
};

// The codes of elements i0 .. i0 + kOut - 1, raw, in w: one load of kBytes
// where they start on a kBytes boundary (and, packed, on a whole byte),
// else one load per element, re-packed.
template <int MODE, typename OutT>
__device__ __forceinline__ void load_codes(const void* codes, long long row,
                                           long long i0, unsigned (&w)[4]) {
  using V = DecodeVec<MODE, OutT>;
  const char* base = static_cast<const char*>(codes);
  const char* p = MODE == 0   ? base + row + (i0 >> 1)
                  : MODE == 1 ? base + row + i0
                              : base + 2 * (row + i0);
  const bool whole = MODE != 0 || (i0 & 1) == 0;
  if (whole && (reinterpret_cast<uintptr_t>(p) & (V::kBytes - 1)) == 0) {
    if (V::kBytes == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if (V::kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else if (V::kBytes == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
  for (int j = 0; j < V::kOut; ++j) {
    w[j / V::kPer] |= code_at<MODE>(codes, row, i0 + j)
                      << (V::kBits * (j % V::kPer));
  }
}

template <int MODE, typename OutT>
__device__ __forceinline__ void decode_store(const unsigned (&w)[4], float s,
                                             float m, OutT* p) {
  using V = DecodeVec<MODE, OutT>;
  float v[V::kOut];
#pragma unroll
  for (int j = 0; j < V::kOut; ++j) {
    const unsigned c = (w[j / V::kPer] >> (V::kBits * (j % V::kPer))) &
                       ((1u << V::kBits) - 1u);
    v[j] = fmaf(static_cast<float>(c), s, m);
  }
  store16(p, v);
}

// K2: grid (blocks, B), one sample a row of blocks. The sample's row splits
// into `head` elements before its output is 16-byte aligned, `nvec`
// vectors of one 16-byte store each, then a tail. A thread takes kUnroll
// vectors blockDim apart a step, all loads first, so each warp-wide store
// covers 512 contiguous bytes and every load is in flight before the first
// store; the first block's first threads write the head and tail one
// element each. The step is (mx - mn) * recip, IEEE subtract and multiply
// as the reference's compiled decode; each element is fmaf(code, step, mn).
constexpr int kUnroll = 4;

template <int MODE, typename OutT>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const void* __restrict__ codes, long long in_n, long long n,
               const float* __restrict__ mn, const float* __restrict__ mx,
               float recip, OutT* __restrict__ out) {
  constexpr int kOut = DecodeVec<MODE, OutT>::kOut;
  const int b = blockIdx.y;
  const float m = mn[b];
  const float s = __fmul_rn(__fsub_rn(mx[b], m), recip);
  const long long row = static_cast<long long>(b) * in_n;
  OutT* o = out + static_cast<long long>(b) * n;
  const long long head = min(head_elems(o), n);
  const long long nvec = (n - head) / kOut;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x *
                         kUnroll;
  for (long long k0 = static_cast<long long>(blockIdx.x) * blockDim.x *
                          kUnroll + threadIdx.x;
       k0 < nvec; k0 += step) {
    unsigned w[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + static_cast<long long>(u) * blockDim.x;
      if (k < nvec) load_codes<MODE, OutT>(codes, row, head + k * kOut, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + static_cast<long long>(u) * blockDim.x;
      if (k < nvec) decode_store<MODE, OutT>(w[u], s, m, o + head + k * kOut);
    }
  }
  const long long body_end = head + nvec * kOut;
  if (blockIdx.x == 0 && threadIdx.x < head + (n - body_end)) {
    const long long e = threadIdx.x;
    const long long i = e < head ? e : body_end + (e - head);
    store_out(o, i,
              fmaf(static_cast<float>(code_at<MODE>(codes, row, i)), s, m));
  }
}

template <typename T>
int launch_encode(const T* x, int batch, long long n, int bits, float* pmin,
                  float* pmax, int parts, int blocks, float* mn, float* mx,
                  void* out, long long out_n, cudaStream_t stream) {
  const float levels = static_cast<float>((1u << bits) - 1u);
  minmax_partials_kernel<T><<<dim3(parts, batch), kThreads, 0, stream>>>(
      x, n, pmin, pmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, batch);
  if (bits <= 4) {
    quantize_pack_kernel<T, 0><<<grid, kThreads, 0, stream>>>(
        x, n, pmin, pmax, parts, levels, mn, mx, out, out_n);
  } else if (bits <= 8) {
    quantize_pack_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        x, n, pmin, pmax, parts, levels, mn, mx, out, out_n);
  } else {
    quantize_pack_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        x, n, pmin, pmax, parts, levels, mn, mx, out, out_n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename OutT>
int launch_decode(const void* codes, int batch, long long in_n, long long n,
                  const float* mn, const float* mx, float recip, OutT* out,
                  int max_blocks, cudaStream_t stream) {
  constexpr long long kOut = DecodeVec<MODE, OutT>::kOut;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long want = (n / kOut + per_block - 1) / per_block;
  const long long cap = max_blocks / batch > 1 ? max_blocks / batch : 1;
  const int blocks =
      static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  dequant_kernel<MODE, OutT><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      codes, in_n, n, mn, mx, recip, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int decode_dispatch(const void* codes, int mode, int batch, long long in_n,
                    long long n, const float* mn, const float* mx,
                    float recip, OutT* out, int max_blocks,
                    cudaStream_t stream) {
  if (mode == 0) {
    return launch_decode<0>(codes, batch, in_n, n, mn, mx, recip, out,
                            max_blocks, stream);
  } else if (mode == 1) {
    return launch_decode<1>(codes, batch, in_n, n, mn, mx, recip, out,
                            max_blocks, stream);
  }
  return launch_decode<2>(codes, batch, in_n, n, mn, mx, recip, out,
                          max_blocks, stream);
}

}  // namespace

extern "C" {

// K1: x (B, n) f32 (in_bf16 = 0) or bf16 -> out (B, out_n) codes,
// mn/mx (B,). pmin/pmax are (B, parts) scratch. Two launches.
int jalad_fused_encode(const void* x, int in_bf16, int batch, long long n,
                       int bits, float* pmin, float* pmax, int parts,
                       int blocks, float* mn, float* mx, void* out,
                       long long out_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_encode(static_cast<const __nv_bfloat16*>(x), batch, n, bits,
                         pmin, pmax, parts, blocks, mn, mx, out, out_n, s);
  }
  return launch_encode(static_cast<const float*>(x), batch, n, bits, pmin,
                       pmax, parts, blocks, mn, mx, out, out_n, s);
}

// K2: codes (B, in_n) + ranges mn / mx (B,) -> out (B, n) f32
// (out_bf16 = 0) or bf16, recip = f32(1) / f32(2^c - 1). mode: 0
// nibble-packed u8, 1 u8, 2 u16. One launch of at most max_blocks blocks.
int jalad_fused_decode(const void* codes, int mode, int batch, long long in_n,
                       long long n, const float* mn, const float* mx,
                       float recip, void* out, int out_bf16, int max_blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return decode_dispatch(codes, mode, batch, in_n, n, mn, mx, recip,
                           static_cast<__nv_bfloat16*>(out), max_blocks, s);
  }
  return decode_dispatch(codes, mode, batch, in_n, n, mn, mx, recip,
                         static_cast<float*>(out), max_blocks, s);
}

}  // extern "C"
