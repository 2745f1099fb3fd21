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
// 8 * channels) / 3.35 TB/s.
//
// K4 is one launch that reads the input once, a thread block cluster
// (Hopper) per (b, c). One block per channel left the card half empty where
// B * C is small (the stem boundary of one request has 64 channels on 132
// SMs), and a range pass followed by a pack pass read every channel twice.
// So the host picks a cluster of 1-8 blocks (the portable sizes) that
// brings B * C * cluster to about 528 blocks, each with at least 2048
// elements: 8 at the stem boundary, 1 where C >= 1000 (res5, gap, fc) or
// channels are short, and a cluster of 1 is a plain launch (on the H100 a
// cluster launch of single blocks ran res5 and gap twice as slow). The channel's W words are split into
// `cluster` contiguous shares (rank r takes words [r * W / cluster,
// (r + 1) * W / cluster)), so every share starts on a word and no word
// straddles two blocks. Each block loads its share once into shared memory
// (16-byte loads where the runs allow them) and reduces its own (min, max);
// after a cluster.sync() every block reads the others' through distributed
// shared memory (cluster.map_shared_rank), packs its share from shared
// memory, a thread a word, with coalesced word stores, and rank 0 writes the
// range. The share sits in shared memory with one spare float every 32, so
// the pack's reads, k = 32 / c floats apart between lanes, fall at most two
// to a bank (16 to a bank at 2 bits without the spare). Where a channel is
// too long for the cluster to hold (more than 8 shares of the host's
// PC_SHARE_MAX_FLOATS), a second variant reduces the range in a first read
// and then re-reads its share from L2 for the pack, a tile of shared memory
// at a time. The host picks the variant by size.
//
// K5 is one launch and one pass in two variants, picked by the host from inner.
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
// one fmaf, as the reference's jitted decode rounds once. K4's ranges fold
// in the reference's order, -0.0 < +0.0 (ranges.cuh), so a channel holding
// both zeros gets the reference's header bits whatever the fold order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ranges.cuh"

namespace cg = cooperative_groups;

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

// K4's shared layout: element a of a tile at a + a / 32, one spare float
// every 32, so the pack's stride-k reads fall at most two to a bank.
__device__ __forceinline__ unsigned pad_idx(unsigned a) { return a + (a >> 5); }
// A tile's element l sits at a = l - e0 + kLead: the 16-byte loads start up
// to three elements before e0.
constexpr unsigned kLead = 32;

// Channel elements [e0, e1) of xs (channel c of sample b, read through the
// (outer, C, inner) strides) into lo / hi, and, with STORE, into s. With vec
// (inner % 4 == 0 and x 16-byte aligned) a thread takes aligned quads, each
// inside one run of the channel; quads reach up to three elements past each
// end of [e0, e1), all inside the channel, which leaves the channel's range
// unchanged.
template <bool STORE>
__device__ __forceinline__ void load_share(const float* __restrict__ xs,
                                           unsigned e0, unsigned e1,
                                           unsigned inner, FastDiv by_inner,
                                           long long row, bool vec,
                                           float* s, KeyRange& range) {
  if (vec) {
    const unsigned q1 = (e1 + 3) >> 2;
#pragma unroll 4
    for (unsigned q = (e0 >> 2) + threadIdx.x; q < q1; q += blockDim.x) {
      const unsigned l = q << 2;
      const unsigned o = fdiv(l, by_inner);
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          xs + o * row + (l - o * inner)));
      range.add(v.x);
      range.add(v.y);
      range.add(v.z);
      range.add(v.w);
      if (STORE) {
        const unsigned a = l + kLead - e0;
        s[pad_idx(a)] = v.x;
        s[pad_idx(a + 1)] = v.y;
        s[pad_idx(a + 2)] = v.z;
        s[pad_idx(a + 3)] = v.w;
      }
    }
  } else {
#pragma unroll 4
    for (unsigned l = e0 + threadIdx.x; l < e1; l += blockDim.x) {
      const unsigned o = fdiv(l, by_inner);
      const float v = xs[o * row + (l - o * inner)];
      range.add(v);
      if (STORE) s[pad_idx(l + kLead - e0)] = v;
    }
  }
}

// Words [w0, w1) of the channel from the tile in s, which starts at
// element w0 * k: a thread a word, 32 / BITS codes each.
template <int BITS>
__device__ __forceinline__ void pack_share(const float* s, unsigned w0,
                                           unsigned w1, unsigned length,
                                           float lo, float scale,
                                           uint32_t* __restrict__ out) {
  constexpr unsigned kPerWord = 32 / BITS;
  const float levels = static_cast<float>((1u << BITS) - 1u);
  for (unsigned w = w0 + threadIdx.x; w < w1; w += blockDim.x) {
    const unsigned l0 = w * kPerWord;
    const unsigned a0 = (w - w0) * kPerWord + kLead;
    uint32_t word = 0;
#pragma unroll
    for (unsigned k = 0; k < kPerWord; ++k) {
      if (l0 + k < length) {
        float q = rintf(__fmul_rn(__fsub_rn(s[pad_idx(a0 + k)], lo), scale));
        q = fminf(fmaxf(q, 0.0f), levels);
        word |= static_cast<uint32_t>(q) << (k * BITS);
      }
    }
    out[w] = word;
  }
}

// K4: grid (C * cs, B) in clusters of (cs, 1, 1) (a plain launch when cs
// is 1); rank r of the cluster of (b, c) owns words [r * W / cs,
// (r + 1) * W / cs) of the channel. x is the (B, outer, C, inner) float32
// stack; words (B, C, W); mn / mx (B, C). STAGED: the share stays in
// dynamic shared memory from the one read; otherwise tiles of tile_words
// words are re-read for the pack.
template <int BITS, bool STAGED>
__global__ void __launch_bounds__(256)
pc_encode_kernel(const float* __restrict__ x, int outer, int channels,
                 int inner, FastDiv by_inner, int vec, unsigned cs,
                 unsigned tile_words, float* __restrict__ mn_out,
                 float* __restrict__ mx_out, uint32_t* __restrict__ words,
                 int n_words) {
  constexpr unsigned kPerWord = 32 / BITS;
  extern __shared__ float s_x[];
  __shared__ int s_range[2];
  __shared__ int s_all[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cs > 1 ? cluster.block_rank() : 0u;
  const int c = blockIdx.x / cs;
  const int b = blockIdx.y;
  const unsigned length = static_cast<unsigned>(outer) * inner;
  const long long row = static_cast<long long>(channels) * inner;
  const float* xs = x + static_cast<long long>(b) * outer * row +
                    static_cast<long long>(c) * inner;
  const unsigned w0 = static_cast<unsigned>(
      static_cast<unsigned long long>(rank) * n_words / cs);
  const unsigned w1 = static_cast<unsigned>(
      static_cast<unsigned long long>(rank + 1) * n_words / cs);
  const unsigned e0 = w0 * kPerWord;
  const unsigned e1 = min(w1 * kPerWord, length);

  KeyRange range;
  if (e0 < e1)
    load_share<STAGED>(xs, e0, e1, inner, by_inner, row, vec, s_x, range);
  block_range(range);
  if (cs > 1) {
    if (threadIdx.x == 0) {
      s_range[0] = range.lo;
      s_range[1] = range.hi;
    }
    cluster.sync();
    if (threadIdx.x < 32) {
      KeyRange all;
      if (threadIdx.x < cs) {
        const int* r = cluster.map_shared_rank(s_range, threadIdx.x);
        all.add(r[0], r[1]);
      }
      warp_range(all);
      if (threadIdx.x == 0) {
        s_all[0] = all.lo;
        s_all[1] = all.hi;
      }
    }
    __syncthreads();
    range.lo = s_all[0];
    range.hi = s_all[1];
  }
  const float lo = range.min_value();
  const float hi = range.max_value();
  if (rank == 0 && threadIdx.x == 0) {
    const long long bc = static_cast<long long>(b) * channels + c;
    mn_out[bc] = lo;
    mx_out[bc] = hi;
  }
  const float levels = static_cast<float>((1u << BITS) - 1u);
  const float scale = hi > lo ? __fdiv_rn(levels, __fsub_rn(hi, lo)) : 0.0f;

  uint32_t* out = words + (static_cast<long long>(b) * channels + c) * n_words;
  if (STAGED) {
    pack_share<BITS>(s_x, w0, w1, length, lo, scale, out);
  } else {
    for (unsigned t0 = w0; t0 < w1; t0 += tile_words) {
      const unsigned t1 = min(t0 + tile_words, w1);
      KeyRange unused;
      load_share<true>(xs, t0 * kPerWord, min(t1 * kPerWord, length), inner,
                       by_inner, row, vec, s_x, unused);
      __syncthreads();
      pack_share<BITS>(s_x, t0, t1, length, lo, scale, out);
      __syncthreads();
    }
  }
  // No block may leave while another can still read its s_range.
  if (cs > 1) cluster.sync();
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

template <int BITS, bool STAGED>
int launch_encode_variant(const float* x, int batch, int outer, int channels,
                          int inner, float* mn, float* mx, uint32_t* words,
                          int n_words, int threads, int cluster,
                          unsigned tile_words, int smem_bytes,
                          cudaStream_t stream) {
  auto kernel = pc_encode_kernel<BITS, STAGED>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = inner % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const unsigned cs = static_cast<unsigned>(cluster);
  if (cluster == 1) {
    // A plain launch: a cluster launch of single blocks schedules slower.
    kernel<<<dim3(channels, batch), threads, smem_bytes, stream>>>(
        x, outer, channels, inner, make_fastdiv(inner), vec, cs, tile_words,
        mn, mx, words, n_words);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(channels) * cluster, batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, x, outer, channels, inner, make_fastdiv(inner), vec, cs,
      tile_words, mn, mx, words, n_words);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_encode(const float* x, int batch, int outer, int channels,
                  int inner, float* mn, float* mx, uint32_t* words,
                  int n_words, int threads, int cluster, int staged,
                  unsigned tile_words, int smem_bytes, cudaStream_t stream) {
  if (staged)
    return launch_encode_variant<BITS, true>(
        x, batch, outer, channels, inner, mn, mx, words, n_words, threads,
        cluster, tile_words, smem_bytes, stream);
  return launch_encode_variant<BITS, false>(
      x, batch, outer, channels, inner, mn, mx, words, n_words, threads,
      cluster, tile_words, smem_bytes, stream);
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
// (B, C) f32. One launch of B * C clusters of `cluster` (1-8; 1 is a plain
// launch) blocks of
// `threads` (a multiple of 32, at most 256) with smem_bytes of dynamic
// shared memory: the share of each block (staged = 1) or a tile of
// tile_words words (staged = 0). The host sizes all of them
// (kernels/quantize/ops.py pc_encode_plan).
int jalad_pc_encode(const float* x, int batch, int outer, int channels,
                    int inner, int bits, float* mn, float* mx, void* words,
                    int n_words, int threads, int cluster, int staged,
                    int tile_words, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(words);
  if (cluster < 1 || cluster > 8 || threads < 32 || threads > 256 ||
      tile_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define PC_ENCODE_CASE(B)                                                    \
  case B:                                                                    \
    return launch_encode<B>(x, batch, outer, channels, inner, mn, mx, w,     \
                            n_words, threads, cluster, staged,               \
                            static_cast<unsigned>(tile_words), smem_bytes, s);
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
