// Per-channel boundary-codec kernels for Hopper (sm_90a): K4 and K5.
//
// K4  per-channel encode — replaces repro/kernels/quantize/quantize.py
//     `pc_encode_blocks` (Pallas `_pc_encode_kernel`) together with the
//     per-channel jnp.min / jnp.max its caller runs first
//     (repro/kernels/quantize/ops.py `perchannel_encode_batch_impl`). For
//     each (sample b, channel c): mn, mx over the channel's L elements, then
//     q = clip(rint((x - mn) * scale), 0, 2^c - 1), scale = (2^c-1)/(mx-mn)
//     (0 when mx == mn), then 32 / c codes per u32 word, code k at bit k*c;
//     codes past L are 0 and channels never share a word.
// K5  per-channel decode — replaces `pc_decode_blocks` (`_pc_decode_kernel`):
//     unpack, fmaf(code, step, mn) per channel rounded once, cast to f32 or
//     bf16. step = (mx - mn) * f32(1 / (2^c - 1)) is computed by the caller.
//
// Layout without a transpose copy. The reference moves the channel axis to
// the front (a (B, C, L) copy) before its kernels. Here a (B, *shape) stack
// is read as (B, outer, C, inner) through strides: channel c's element
// l = o * inner + i sits at o * C * inner + c * inner + i of its sample. An
// NCHW boundary (channel axis 1) has outer = N, inner = H*W; a (B, D)
// boundary (trailing axis) has outer = B, inner = 1. K5 writes back through
// the same indexing, so neither direction pays a 12.8 MB round trip of
// transpose at the stem boundary.
//
// Bound on this card: bytes. A few integer and float operations per element
// against 4 bytes read, so the least time is (4 * elements + 4 * words +
// 8 * channels) / 3.35 TB/s. K4 is one launch, one block per (b, c): the
// block reduces its channel's range, then packs its words, one thread per
// word reading that word's 32 / c elements. The channel is read twice, the
// second time mostly from L2 (a stem channel is 200 KB). At B * C < 132
// blocks (the stem boundary of one request has 64 channels) the card is
// not full; a later change may split a channel over several blocks. K5 is
// one pass, one thread per output element in output order: writes are
// coalesced, and neighbouring threads read the same word.
//
// Numerics: IEEE subtract, multiply and divide through the _rn intrinsics
// (never contracted, never fast-math) and rintf (round half to even, as
// jnp.round), so words are bit-identical to the reference; the decode uses
// one fmaf, as the reference's jitted decode rounds once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by a multiply-high and a shift
// (the magic-number division of Granlund and Montgomery).
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_fastdiv(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long one = 1;
  const unsigned m =
      static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1);
  return FastDiv{d, m, s};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
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

// K4: grid (C, B), blockDim a multiple of 32. x is the (B, outer, C, inner)
// float32 stack; words (B, C, W); mn / mx (B, C).
template <int BITS>
__global__ void pc_encode_kernel(const float* __restrict__ x, int outer,
                                 int channels, int inner, FastDiv by_inner,
                                 float* __restrict__ mn_out,
                                 float* __restrict__ mx_out,
                                 uint32_t* __restrict__ words, int n_words) {
  constexpr int kPerWord = 32 / BITS;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const unsigned length = static_cast<unsigned>(outer) * inner;
  const long long row = static_cast<long long>(channels) * inner;
  const float* xs = x + static_cast<long long>(b) * outer * row +
                    static_cast<long long>(c) * inner;

  float lo = INFINITY;
  float hi = -INFINITY;
#pragma unroll 4
  for (unsigned l = threadIdx.x; l < length; l += blockDim.x) {
    const unsigned o = fdiv(l, by_inner);
    const float v = xs[o * row + (l - o * inner)];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  block_minmax(lo, hi);
  const long long bc = static_cast<long long>(b) * channels + c;
  if (threadIdx.x == 0) {
    mn_out[bc] = lo;
    mx_out[bc] = hi;
  }
  const float levels = static_cast<float>((1u << BITS) - 1u);
  const float scale = hi > lo ? __fdiv_rn(levels, __fsub_rn(hi, lo)) : 0.0f;

  uint32_t* out = words + bc * n_words;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    const unsigned l0 = static_cast<unsigned>(w) * kPerWord;
    unsigned o = fdiv(l0, by_inner);
    unsigned i = l0 - o * inner;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < kPerWord; ++k) {
      if (l0 + k < length) {
        float q = rintf(__fmul_rn(__fsub_rn(xs[o * row + i], lo), scale));
        q = fminf(fmaxf(q, 0.0f), levels);
        word |= static_cast<uint32_t>(q) << (k * BITS);
      }
      if (++i == static_cast<unsigned>(inner)) {
        i = 0;
        ++o;
      }
    }
    out[w] = word;
  }
}

__device__ __forceinline__ void store_out(float* p, long long i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, long long i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

// K5: grid (blocks, B), one thread per output element p of a sample in
// output order (p = o * C * inner + c * inner + i).
template <int BITS, typename OutT>
__global__ void pc_decode_kernel(const uint32_t* __restrict__ words,
                                 int channels, int inner, FastDiv by_row,
                                 FastDiv by_inner, int n_words,
                                 const float* __restrict__ mn,
                                 const float* __restrict__ step, unsigned n,
                                 OutT* __restrict__ out) {
  constexpr unsigned kPerWord = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int b = blockIdx.y;
  const unsigned row = static_cast<unsigned>(channels) * inner;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const unsigned o = fdiv(p, by_row);
    const unsigned r = p - o * row;
    const unsigned c = fdiv(r, by_inner);
    const unsigned l = o * inner + (r - c * inner);
    const long long bc = static_cast<long long>(b) * channels + c;
    const uint32_t word = words[bc * n_words + l / kPerWord];
    const unsigned q = (word >> ((l % kPerWord) * BITS)) & kMask;
    store_out(out, static_cast<long long>(b) * n + p,
              fmaf(static_cast<float>(q), step[bc], mn[bc]));
  }
}

template <int BITS>
int launch_encode(const float* x, int batch, int outer, int channels,
                  int inner, float* mn, float* mx, uint32_t* words,
                  int n_words, int threads, cudaStream_t stream) {
  pc_encode_kernel<BITS><<<dim3(channels, batch), threads, 0, stream>>>(
      x, outer, channels, inner, make_fastdiv(inner), mn, mx, words, n_words);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename OutT>
int launch_decode(const uint32_t* words, int batch, int outer, int channels,
                  int inner, int n_words, const float* mn, const float* step,
                  OutT* out, int blocks, cudaStream_t stream) {
  const unsigned n = static_cast<unsigned>(outer) * channels * inner;
  pc_decode_kernel<BITS, OutT><<<dim3(blocks, batch), 256, 0, stream>>>(
      words, channels, inner, make_fastdiv(static_cast<unsigned>(channels) *
                                           inner),
      make_fastdiv(inner), n_words, mn, step, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int decode_dispatch(const uint32_t* words, int batch, int outer,
                    int channels, int inner, int bits, int n_words,
                    const float* mn, const float* step, OutT* out, int blocks,
                    cudaStream_t s) {
#define PC_DECODE_CASE(B)                                                    \
  case B:                                                                    \
    return launch_decode<B, OutT>(words, batch, outer, channels, inner,      \
                                  n_words, mn, step, out, blocks, s);
  switch (bits) {
    PC_DECODE_CASE(1) PC_DECODE_CASE(2) PC_DECODE_CASE(3) PC_DECODE_CASE(4)
    PC_DECODE_CASE(5) PC_DECODE_CASE(6) PC_DECODE_CASE(7) PC_DECODE_CASE(8)
    PC_DECODE_CASE(9) PC_DECODE_CASE(10) PC_DECODE_CASE(11)
    PC_DECODE_CASE(12) PC_DECODE_CASE(13) PC_DECODE_CASE(14)
    PC_DECODE_CASE(15) PC_DECODE_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PC_DECODE_CASE
}

}  // namespace

extern "C" {

// K4: x (B, outer, C, inner) f32 -> words (B, C, n_words) u32, mn / mx
// (B, C) f32. One launch of B * C blocks of `threads` (a multiple of 32,
// at most 1024).
int jalad_pc_encode(const float* x, int batch, int outer, int channels,
                    int inner, int bits, float* mn, float* mx, void* words,
                    int n_words, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(words);
#define PC_ENCODE_CASE(B)                                                    \
  case B:                                                                    \
    return launch_encode<B>(x, batch, outer, channels, inner, mn, mx, w,     \
                            n_words, threads, s);
  switch (bits) {
    PC_ENCODE_CASE(1) PC_ENCODE_CASE(2) PC_ENCODE_CASE(3) PC_ENCODE_CASE(4)
    PC_ENCODE_CASE(5) PC_ENCODE_CASE(6) PC_ENCODE_CASE(7) PC_ENCODE_CASE(8)
    PC_ENCODE_CASE(9) PC_ENCODE_CASE(10) PC_ENCODE_CASE(11)
    PC_ENCODE_CASE(12) PC_ENCODE_CASE(13) PC_ENCODE_CASE(14)
    PC_ENCODE_CASE(15) PC_ENCODE_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PC_ENCODE_CASE
}

// K5: words (B, C, n_words) u32 + mn / step (B, C) f32 -> out (B, outer,
// C, inner) f32 (out_bf16 = 0) or bf16. One launch.
int jalad_pc_decode(const void* words, int batch, int outer, int channels,
                    int inner, int bits, int n_words, const float* mn,
                    const float* step, void* out, int out_bf16, int blocks,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (out_bf16) {
    return decode_dispatch(w, batch, outer, channels, inner, bits, n_words,
                           mn, step, static_cast<__nv_bfloat16*>(out), blocks,
                           s);
  }
  return decode_dispatch(w, batch, outer, channels, inner, bits, n_words, mn,
                         step, static_cast<float*>(out), blocks, s);
}

}  // extern "C"
