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
//     f32 or bf16. step = (mx - mn) / (2^c - 1) is computed by the caller.
//
// Bound on this card: bytes. Both kernels do a handful of flops per byte
// (far below the H100's ~20 flop/byte float32 ridge), so the least time is
// (bytes in + bytes out) / 3.35 TB/s. K1 must know each sample's global range
// before it writes any code, and blocks on a GPU run in no order, so it is
// two launches: a grid-wide partial min/max reduction, then the quantize +
// pack pass, whose blocks each fold the (few hundred) partials of their
// sample before streaming the input a second time. The input is read twice
// (the TPU kernel also streams it twice); the codes are written once and
// never round-trip device memory between the affine map and the pack. K2 is
// one pass: every code byte read once, every output element written once.
// Loads and stores are coalesced (neighbouring threads, neighbouring
// elements); a later change may widen them to 16-byte vectors.
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

__device__ __forceinline__ void store_out(float* p, long long i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, long long i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

// K2: grid (blocks, B). MODE 0: nibble-packed u8 (element i in byte i >> 1,
// low nibble when i is even). MODE 1: u8 codes. MODE 2: u16 codes.
template <int MODE, typename OutT>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const void* __restrict__ codes, long long in_n, long long n,
               const float* __restrict__ mn, const float* __restrict__ step,
               OutT* __restrict__ out) {
  const int b = blockIdx.y;
  const float m = mn[b];
  const float s = step[b];
  const long long in_base = static_cast<long long>(b) * in_n;
  const long long out_base = static_cast<long long>(b) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    unsigned q;
    if (MODE == 0) {
      const uint8_t byte = static_cast<const uint8_t*>(codes)[in_base + (i >> 1)];
      q = (i & 1) ? (byte >> 4) : (byte & 0x0Fu);
    } else if (MODE == 1) {
      q = static_cast<const uint8_t*>(codes)[in_base + i];
    } else {
      q = static_cast<const uint16_t*>(codes)[in_base + i];
    }
    store_out(out, out_base + i, fmaf(static_cast<float>(q), s, m));
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

template <typename OutT>
int launch_decode(const void* codes, int mode, int batch, long long in_n,
                  long long n, const float* mn, const float* step, OutT* out,
                  int blocks, cudaStream_t stream) {
  const dim3 grid(blocks, batch);
  if (mode == 0) {
    dequant_kernel<0, OutT><<<grid, kThreads, 0, stream>>>(codes, in_n, n, mn,
                                                           step, out);
  } else if (mode == 1) {
    dequant_kernel<1, OutT><<<grid, kThreads, 0, stream>>>(codes, in_n, n, mn,
                                                           step, out);
  } else {
    dequant_kernel<2, OutT><<<grid, kThreads, 0, stream>>>(codes, in_n, n, mn,
                                                           step, out);
  }
  return static_cast<int>(cudaGetLastError());
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

// K2: codes (B, in_n) -> out (B, n) f32 (out_bf16 = 0) or bf16.
// mode: 0 nibble-packed u8, 1 u8, 2 u16. One launch.
int jalad_fused_decode(const void* codes, int mode, int batch, long long in_n,
                       long long n, const float* mn, const float* step,
                       void* out, int out_bf16, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch_decode(codes, mode, batch, in_n, n, mn, step,
                         static_cast<__nv_bfloat16*>(out), blocks, s);
  }
  return launch_decode(codes, mode, batch, in_n, n, mn, step,
                       static_cast<float*>(out), blocks, s);
}

}  // extern "C"
