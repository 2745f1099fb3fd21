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
//     bf16. step = (mx - mn) * f32(1 / (2^c - 1)) is computed in the kernel,
//     once per tile (the reference computes it outside its kernel).
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
// one launch and one pass in two variants, picked by the host from inner.
// Where a channel's output runs are long (the NCHW stem and res5
// boundaries: 12,544 and 49 contiguous floats) a warp owns a piece of one
// run: its words are staged once in shared memory, the index arithmetic
// and the step are done once a tile, and the floats go out as 16-byte
// stores, four codes a lane. Where runs are short (a (B, D) boundary has
// inner = 1, channels C elements apart) a tile has nothing to reuse, and
// one thread per output element in output order keeps the writes
// coalesced while neighbouring threads read the same word.
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

// Four floats to p, aligned to four elements: one float4 store, or four
// bf16 (__float2bfloat16_rn each) in one 8-byte store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
}

// K5, element variant, for short runs (inner below the host's threshold):
// grid (blocks, B), one thread per output element p of a sample in output
// order (p = o * C * inner + c * inner + i).
template <int BITS, typename OutT>
__global__ void pc_decode_kernel(const uint32_t* __restrict__ words,
                                 int channels, int inner, FastDiv by_row,
                                 FastDiv by_inner, int n_words,
                                 const float* __restrict__ mn,
                                 const float* __restrict__ mx, float recip,
                                 unsigned n, OutT* __restrict__ out) {
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
    const float m = mn[bc];
    const float s = __fmul_rn(__fsub_rn(mx[bc], m), recip);
    store_out(out, static_cast<long long>(b) * n + p,
              fmaf(static_cast<float>(q), s, m));
  }
}

// K5, tiled variant, for long runs: a warp owns one tile, a piece of at
// most kTile elements of one (b, o, c) output run. It stages the tile's
// words in shared memory with coalesced 4-byte loads (the first and last
// word may hold codes of the neighbouring tiles), computes the channel's
// step once, then writes the piece in output order, four codes a lane: one
// 16-byte (f32) or 8-byte (bf16) store from where the output is aligned to
// four elements, scalar stores for the up-to-three head and tail elements.
// Warps stride over the tiles independently, so a run of 49 elements (res5)
// keeps a warp, not a block, busy.
constexpr int kTileWarps = 8;
constexpr int kTile = 32 * 4 * 8;   // 8 four-code groups a lane

template <int BITS, typename OutT>
__global__ void __launch_bounds__(kTileWarps * 32)
pc_decode_tiled_kernel(const uint32_t* __restrict__ words, int channels,
                       int inner, int n_words, unsigned pieces,
                       FastDiv by_pieces, unsigned piece_len,
                       unsigned row_runs, FastDiv by_row_runs,
                       FastDiv by_channels, unsigned n_tiles,
                       const float* __restrict__ mn,
                       const float* __restrict__ mx, float recip, unsigned n,
                       OutT* __restrict__ out) {
  constexpr unsigned kPerWord = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  // A tile's codes start anywhere in their first word.
  constexpr int kStage = (kTile + kPerWord - 1) / kPerWord + 1;
  __shared__ uint32_t s_words[kTileWarps][kStage];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  uint32_t* sw = s_words[warp];
  for (unsigned t = blockIdx.x * kTileWarps + warp; t < n_tiles;
       t += gridDim.x * kTileWarps) {
    const unsigned run = fdiv(t, by_pieces);
    const unsigned t0 = (t - run * pieces) * piece_len;
    const unsigned len = min(piece_len, inner - t0);
    const unsigned b = fdiv(run, by_row_runs);
    const unsigned oc = run - b * row_runs;
    const unsigned o = fdiv(oc, by_channels);
    const long long bc =
        static_cast<long long>(b) * channels + (oc - o * channels);
    const float m = mn[bc];
    const float s = __fmul_rn(__fsub_rn(mx[bc], m), recip);
    // The tile's first code in its channel, and the words it spans.
    const unsigned l0 = o * inner + t0;
    const unsigned w0 = l0 / kPerWord;
    const unsigned n_stage = (l0 + len - 1) / kPerWord + 1 - w0;
    const uint32_t* src = words + bc * n_words + w0;
    for (unsigned j = lane; j < n_stage; j += 32) sw[j] = src[j];
    __syncwarp();
    OutT* dst = out + static_cast<long long>(b) * n +
                static_cast<long long>(oc) * inner + t0;
    const unsigned mis =
        static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst) /
                              sizeof(OutT)) & 3u;
    const unsigned head = min((4u - mis) & 3u, len);
    const unsigned groups = (len - head) / 4;
    const unsigned r0 = l0 - w0 * kPerWord;
    for (unsigned g = lane; g < groups; g += 32) {
      const unsigned e = head + 4 * g;
      unsigned q = (r0 + e) / kPerWord;
      unsigned r = (r0 + e) - q * kPerWord;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = fmaf(static_cast<float>((sw[q] >> (r * BITS)) & kMask), s, m);
        if (++r == kPerWord) {
          r = 0;
          ++q;
        }
      }
      store4(dst + e, v);
    }
    const unsigned body_end = head + 4 * groups;
    if (lane < head + (len - body_end)) {
      const unsigned e = lane < head ? lane : body_end + (lane - head);
      const unsigned q = (r0 + e) / kPerWord;
      const unsigned r = (r0 + e) - q * kPerWord;
      store_out(dst, e,
                fmaf(static_cast<float>((sw[q] >> (r * BITS)) & kMask), s,
                     m));
    }
    __syncwarp();
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
                  int inner, int n_words, const float* mn, const float* mx,
                  float recip, OutT* out, int tiled, int max_blocks,
                  cudaStream_t stream) {
  const unsigned n = static_cast<unsigned>(outer) * channels * inner;
  if (!tiled) {
    const int per_sample = max_blocks / batch > 1 ? max_blocks / batch : 1;
    const unsigned want = (n + 1023u) / 1024u;
    const int blocks =
        static_cast<int>(want < static_cast<unsigned>(per_sample)
                             ? want : per_sample);
    pc_decode_kernel<BITS, OutT><<<dim3(blocks, batch), 256, 0, stream>>>(
        words, channels, inner,
        make_fastdiv(static_cast<unsigned>(channels) * inner),
        make_fastdiv(inner), n_words, mn, mx, recip, n, out);
    return static_cast<int>(cudaGetLastError());
  }
  // Pieces of at most kTile elements, a multiple of 4 long, so every piece
  // of a run but the first starts as aligned as the run does.
  const unsigned first = (inner + kTile - 1) / kTile;
  const unsigned piece_len = ((inner + first - 1) / first + 3) / 4 * 4;
  const unsigned pieces = (inner + piece_len - 1) / piece_len;
  const unsigned row_runs = static_cast<unsigned>(outer) * channels;
  const long long tiles =
      static_cast<long long>(row_runs) * batch * pieces;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (tiles + kTileWarps - 1) / kTileWarps;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  pc_decode_tiled_kernel<BITS, OutT><<<blocks, kTileWarps * 32, 0, stream>>>(
      words, channels, inner, n_words, pieces, make_fastdiv(pieces),
      piece_len, row_runs, make_fastdiv(row_runs), make_fastdiv(channels),
      static_cast<unsigned>(tiles), mn, mx, recip, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int decode_dispatch(const uint32_t* words, int batch, int outer,
                    int channels, int inner, int bits, int n_words,
                    const float* mn, const float* mx, float recip, OutT* out,
                    int tiled, int max_blocks, cudaStream_t s) {
#define PC_DECODE_CASE(B)                                                    \
  case B:                                                                    \
    return launch_decode<B, OutT>(words, batch, outer, channels, inner,      \
                                  n_words, mn, mx, recip, out, tiled,        \
                                  max_blocks, s);
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

// K5: words (B, C, n_words) u32 + ranges mn / mx (B, C) f32 -> out (B,
// outer, C, inner) f32 (out_bf16 = 0) or bf16, recip = f32(1) / f32(2^c -
// 1). tiled picks the variant (the host's choice from inner). One launch
// of at most max_blocks blocks.
int jalad_pc_decode(const void* words, int batch, int outer, int channels,
                    int inner, int bits, int n_words, const float* mn,
                    const float* mx, float recip, void* out, int out_bf16,
                    int tiled, int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (out_bf16) {
    return decode_dispatch(w, batch, outer, channels, inner, bits, n_words,
                           mn, mx, recip, static_cast<__nv_bfloat16*>(out),
                           tiled, max_blocks, s);
  }
  return decode_dispatch(w, batch, outer, channels, inner, bits, n_words, mn,
                         mx, recip, static_cast<float*>(out), tiled,
                         max_blocks, s);
}

}  // extern "C"
