// The three-launch edge encode for Hopper (sm_90a): K6a, K6b and K6c.
//
// This is the reference's first edge encode, kept beside the fused K1 of
// quantize.cu as its byte-identity baseline: the same codes, made in three
// passes with the codes written to device memory and read back between the
// quantize and the pack. Each kernel works on the flat n elements of one
// tensor; the TPU's (M, 128) tiling and its padding have no use here.
//
// K6a  range partials — replaces repro/kernels/quantize/quantize.py
//      `minmax_blocks` (Pallas `_minmax_kernel`). Block p reduces the
//      contiguous chunk [p * chunk, (p + 1) * chunk) of an f32 or bf16 input
//      to one f32 (min, max) pair, in the reference's order -0.0 < +0.0
//      (ranges.cuh). The partials are folded outside the kernels
//      (ordered_amin / ordered_amax of repro_torch.core.quantization on the
//      card), as the reference folds them with jnp.min / jnp.max. Bound: the input read once (12.85 MB for
//      the ResNet-50 stem boundary at batch 4: 3.8 us at 3.35 TB/s).
// K6b  quantize — replaces `quantize_blocks` (`_quantize_kernel`).
//      q = clip(rint((x - mn) * scale), 0, 2^c - 1) with one scalar (mn,
//      scale) read through pointers, so the host never waits for the range;
//      u8 codes at c <= 8, u16 above. Bound: input read + codes written
//      (4.8 us at 8 bits on the stem boundary, 5.8 us at 16 bits).
// K6c  nibble pack — replaces `pack4_blocks` (`_pack4_kernel`), at c <= 4
//      only: byte i = codes[2i] | codes[2i + 1] << 4; an odd count repeats
//      codes[0] in the last high nibble, as the reference pads its tiles with
//      the first element. Bound: codes read + bytes written (1.4 us).
//
// All three move a few bytes per flop, so bytes bound them. The design is
// the simplest that is right: one element (K6a, K6b) or one output byte
// (K6c) per thread per step, neighbouring threads on neighbouring elements
// so every load and store coalesces. Vector loads and fusing the fold into
// K6b are later work; K1 does the whole chain in one launch.
//
// Numerics: __fsub_rn / __fmul_rn are never contracted into an FMA, and
// rintf rounds half to even as jnp.round does, so the codes are the bits of
// K1's and of the reference's.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ranges.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// K6a: grid (parts). Block p folds its chunk into pmin[p], pmax[p].
template <typename T>
__global__ void __launch_bounds__(kThreads)
minmax_blocks_kernel(const T* __restrict__ x, long long n, long long chunk,
                     float* __restrict__ pmin, float* __restrict__ pmax) {
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  KeyRange r;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x)
    r.add(load_f32(x, i));
  block_range(r);
  if (threadIdx.x == 0) {
    pmin[blockIdx.x] = r.min_value();
    pmax[blockIdx.x] = r.max_value();
  }
}

// K6b: grid-stride over the n codes. OutT is uint8_t or uint16_t.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
quantize_blocks_kernel(const T* __restrict__ x, long long n,
                       const float* __restrict__ mn_p,
                       const float* __restrict__ scale_p, float levels,
                       OutT* __restrict__ codes) {
  const float mn = *mn_p;
  const float scale = *scale_p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float q = rintf(__fmul_rn(__fsub_rn(load_f32(x, i), mn), scale));
    q = fminf(fmaxf(q, 0.0f), levels);
    codes[i] = static_cast<OutT>(q);
  }
}

// K6c: grid-stride over the out_n = ceil(n / 2) packed bytes.
__global__ void __launch_bounds__(kThreads)
pack4_blocks_kernel(const uint8_t* __restrict__ codes, long long n,
                    uint8_t* __restrict__ out, long long out_n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < out_n; j += stride) {
    const long long i1 = 2 * j + 1;
    const unsigned lo = codes[2 * j];
    const unsigned hi = codes[i1 < n ? i1 : 0];
    out[j] = static_cast<uint8_t>(lo | (hi << 4));
  }
}

template <typename T>
int launch_quantize(const T* x, long long n, const float* mn,
                    const float* scale, int bits, void* codes, int blocks,
                    cudaStream_t stream) {
  const float levels = static_cast<float>((1u << bits) - 1u);
  if (bits <= 8) {
    quantize_blocks_kernel<T, uint8_t><<<blocks, kThreads, 0, stream>>>(
        x, n, mn, scale, levels, static_cast<uint8_t*>(codes));
  } else {
    quantize_blocks_kernel<T, uint16_t><<<blocks, kThreads, 0, stream>>>(
        x, n, mn, scale, levels, static_cast<uint16_t*>(codes));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6a: x (n,) f32 (in_bf16 = 0) or bf16 -> pmin, pmax (parts,), block p
// covering [p * chunk, min((p + 1) * chunk, n)). One launch.
int jalad_minmax_blocks(const void* x, int in_bf16, long long n,
                        long long chunk, int parts, float* pmin, float* pmax,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    minmax_blocks_kernel<__nv_bfloat16><<<parts, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, chunk, pmin, pmax);
  } else {
    minmax_blocks_kernel<float><<<parts, kThreads, 0, s>>>(
        static_cast<const float*>(x), n, chunk, pmin, pmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b: x (n,) f32 or bf16 + device scalars mn, scale -> codes (n,) u8
// (bits <= 8) or u16. One launch.
int jalad_quantize_blocks(const void* x, int in_bf16, long long n,
                          const float* mn, const float* scale, int bits,
                          void* codes, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_quantize(static_cast<const __nv_bfloat16*>(x), n, mn, scale,
                           bits, codes, blocks, s);
  }
  return launch_quantize(static_cast<const float*>(x), n, mn, scale, bits,
                         codes, blocks, s);
}

// K6c: codes (n,) u8 -> out (out_n,) u8, out_n = ceil(n / 2). One launch.
int jalad_pack4_blocks(const uint8_t* codes, long long n, uint8_t* out,
                       long long out_n, int blocks, void* stream) {
  pack4_blocks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(codes, n, out,
                                                            out_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
