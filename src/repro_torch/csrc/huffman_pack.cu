// Device half of the batched Huffman encode for Hopper (sm_90a): K3.
//
// Replaces repro/kernels/entropy/huffman.py `huffman_pack_blocks` (Pallas
// `_huffman_pack_kernel`). Given each sample's range (mn, scale) and its
// canonical (code, length) table, built on the host from the phase-1
// histogram, turn the float boundary stack into the packed bitstream:
//   re-quantize -> table gather -> exclusive prefix sum of code lengths
//   -> each code MSB-first into u32 words (two parts when it spans a word).
// Bit k of sample b's stream lives in words[b, k >> 5] at bit 31 - (k & 31),
// so writing each word big-endian gives the host encoder's np.packbits bytes.
//
// Bound on this card: bytes (the float input read once, the words written
// once; a few integer ops per element). What stands between a naive kernel
// and that bound is the prefix sum, which crosses blocks, and GPU blocks run
// in no order. The design is one pass with a decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back", the
// scheme of CUB's scan):
//   * a tile is one 4096-element chunk of one sample; each block takes its
//     tile from an atomic ticket, so a tile only ever waits on tiles that
//     were handed out before it and are running (forward progress does not
//     depend on the order blocks are dispatched in). Tiles are numbered
//     sample-major and the look-back stops at the sample's first tile;
//   * the block loads its chunk once, 16 bytes a thread a load (coalesced:
//     round r, thread t holds elements r * 256 * V + t * V + [0, V)),
//     re-quantizes it with quant_code and looks each symbol up once in the
//     tables, staged in shared memory for 2^bits <= 4096 (<= 20 KB) and
//     read through __ldg at 16 bits. The codes stay in registers, the
//     lengths four to a register;
//   * one block scan gives every element's bit offset in the tile: the
//     thread's per-round length sums are packed into one u64 (four 16-bit
//     fields for f32, two 32-bit fields for bf16; a round holds at most
//     1024 x 32 or 2048 x 32 bits, so no field carries into the next);
//   * thread 0 publishes the tile's bit count (flag AGGREGATE) with the
//     tile's last 32 stream bits beside it; then the whole block reads the
//     descriptors of the 256 tiles before it, one a thread, spinning on any
//     not yet published, sums back to the nearest one flagged PREFIX, and
//     publishes its own inclusive prefix. Descriptors are one u64 (flag <<
//     32 | bits) written with st.release and read with ld.acquire; a window
//     of 256, not a warp's 32, lets the prefixes of a wave of ~800 tiles
//     settle in a few rounds;
//   * the tile's words are assembled in a shared-memory buffer (at most
//     4096 x 32 bits + one partial word) with shared atomicOr, each thread
//     running a 64-bit bit-writer over its consecutive codes, and go out as
//     plain coalesced stores. The word a tile shares with its predecessor
//     opens with the predecessor's last bits, from its descriptor (every
//     tile but a sample's last holds at least 4096 bits); the word it shares
//     with its successor is the successor's to write. The sample's last
//     tile also zeroes the rest of the row.
// So a call is one memset (the ticket and the descriptors) and one kernel,
// and every word is written once, without atomics in device memory. With
// a wave of ~800 tiles in flight, the kernel is bound by each tile's chain
// (ticket, load, scan, look-back, emission) more than by bytes, and a tile
// waits in its look-back for the slowest of the tiles before it; so the
// kernel keeps to 40 registers a thread, for six blocks an SM, and to few
// instructions an element. The TPU kernel's sorted-segment emission and
// symbol folding worked around XLA-CPU scatter and TPU scan costs and are
// not needed here.
//
// Numerics: the quantize uses the _rn intrinsics and rintf, bit-identical to
// the reference quantize, so the codes match the host histogram exactly.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;  // resident blocks an SM: at most 40 registers
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // elements per tile
// Words a tile can touch: codes of at most 32 bits, plus one partial word
// when the tile starts inside a word; rounded to 16 bytes.
constexpr int kTileWords = (kChunk * 32 / 32 + 1 + 3) / 4 * 4;
// Tables staged in shared memory up to this many symbols.
constexpr int kStageSymbols = 4096;

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned quant_code(float v, float mn, float scale,
                                               float levels) {
  float q = rintf(__fmul_rn(__fsub_rn(v, mn), scale));
  q = fminf(fmaxf(q, 0.0f), levels);
  return static_cast<unsigned>(q);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One 16-byte load of V = 16 / sizeof(T) elements.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f32(e[k]);
}

// Exclusive scan of v over the block; *total gets the block's sum.
__device__ __forceinline__ unsigned long long block_exclusive_scan(
    unsigned long long v, unsigned long long* total) {
  __shared__ unsigned long long s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long s = s_warp[w];
    if (w < warp) before += s;
    sum += s;
  }
  *total = sum;
  return before + incl - v;
}

// Grid (B * chunks,), kThreads threads, dynamic shared memory: kTileWords
// words, then (2^bits <= kStageSymbols) the code table and the length table.
// scratch: [0] the ticket, [1, 1 + tiles) the descriptors (both zeroed by
// the caller), [1 + tiles, 1 + 2 * tiles) each tile's last 32 stream bits.
// Every code of a symbol that occurs is 1 to 32 bits long, so every tile
// but a sample's last holds at least 4096 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
huffman_pack_kernel(const T* __restrict__ x, long long n, int chunks,
                    int vec, const float* __restrict__ mn,
                    const float* __restrict__ scale,
                    const uint32_t* __restrict__ code_lut,
                    const uint8_t* __restrict__ len_lut, int n_symbols,
                    float levels, unsigned long long* __restrict__ scratch,
                    uint32_t* __restrict__ words, long long w_words) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kRounds = kPerThread / V;
  constexpr int kField = 64 / kRounds;
  constexpr unsigned long long kFieldMask = (1ull << kField) - 1ull;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned s_tile, s_tail, s_prev_tail;
  __shared__ unsigned s_prefix_lanes[kWarps];
  __shared__ unsigned long long s_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* sw = smem;
  uint32_t* s_code = smem + kTileWords;
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_code + n_symbols);
  const bool staged = n_symbols <= kStageSymbols;

  if (threadIdx.x == 0) {
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    s_tail = 0u;
  }
  for (int i = threadIdx.x; i < kTileWords / 4; i += kThreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const unsigned tile = s_tile;
  const int b = static_cast<int>(tile / chunks);
  const int c = static_cast<int>(tile - static_cast<unsigned>(b) * chunks);
  const uint32_t* codes = code_lut + static_cast<long long>(b) * n_symbols;
  const uint8_t* lens = len_lut + static_cast<long long>(b) * n_symbols;

  // One read of the chunk, issued before the tables are staged: element
  // (r, thread, k) of the tile is r * kThreads * V + threadIdx.x * V + k.
  const float m = mn[b];
  const float s = scale[b];
  const T* xs = x + static_cast<long long>(b) * n;
  const long long start = static_cast<long long>(c) * kChunk;
  const bool full = start + kChunk <= n;
  // Symbols (at most 16 bits) two to a register.
  unsigned q2[kPerThread / 2];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i0 = start + (r * kThreads + threadIdx.x) * V;
    float v[V];
    if (vec && (full || i0 + V <= n)) {
      load_vec(xs + i0, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = i0 + k < n ? to_f32(xs[i0 + k]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < V; k += 2) {
      q2[(r * V + k) >> 1] = quant_code(v[k], m, s, levels) |
                             (quant_code(v[k + 1], m, s, levels) << 16);
    }
  }
  if (staged) {
    for (int i = threadIdx.x; i < n_symbols; i += kThreads) {
      s_code[i] = codes[i];
      s_len[i] = lens[i];
    }
  }
  __syncthreads();  // tables staged

  // Look each symbol up once: the codes, and the lengths four to a
  // register. Elements past n get length 0.
  uint32_t code[kPerThread];
  unsigned len4[kPerThread / 4] = {};
  unsigned long long mine = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i0 = start + (r * kThreads + threadIdx.x) * V;
    unsigned sum = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int e = r * V + k;
      const unsigned sym = (q2[e >> 1] >> (16 * (e & 1))) & 0xffffu;
      unsigned l = 0;
      code[e] = 0u;
      if (full || i0 + k < n) {
        l = staged ? s_len[sym] : __ldg(lens + sym);
        code[e] = staged ? s_code[sym] : __ldg(codes + sym);
      }
      len4[e >> 2] |= l << (8 * (e & 3));
      sum += l;
    }
    mine |= static_cast<unsigned long long>(sum) << (r * kField);
  }
  auto len_at = [&](int e) -> unsigned {
    return (len4[e >> 2] >> (8 * (e & 3))) & 0xffu;
  };
  unsigned long long totals;
  const unsigned long long before = block_exclusive_scan(mine, &totals);
  unsigned round_off[kRounds];
  unsigned tile_bits = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    round_off[r] = tile_bits +
        static_cast<unsigned>((before >> (r * kField)) & kFieldMask);
    tile_bits += static_cast<unsigned>((totals >> (r * kField)) & kFieldMask);
  }

  // The tile's last 32 stream bits (right-aligned), which its successor
  // merges into the word the two share.
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned sum =
        static_cast<unsigned>((mine >> (r * kField)) & kFieldMask);
    if (round_off[r] + sum + 32 <= tile_bits) continue;
    unsigned pos = round_off[r];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const unsigned l = len_at(r * V + k);
      pos += l;
      if (l && pos + 32 > tile_bits) {
        const unsigned long long cw = code[r * V + k];
        atomicOr(&s_tail, static_cast<uint32_t>(cw << (tile_bits - pos)));
      }
    }
  }
  __syncthreads();

  // Publish, then look back for the bits of the sample's earlier tiles,
  // kThreads descriptors a round, one a thread.
  unsigned long long* desc = scratch + 1;
  unsigned long long* tails = desc + gridDim.x;
  if (threadIdx.x == 0) {
    tails[tile] = s_tail;
    st_release(desc + tile, (c == 0 ? kPrefix : kAggregate) | tile_bits);
  }
  unsigned long long excl = 0;
  if (c > 0) {
    const unsigned first = tile - c;  // the sample's first tile
    for (int pred = c - 1;; pred -= kThreads) {
      const int j = pred - static_cast<int>(threadIdx.x);
      unsigned long long d = kPrefix;  // before the sample: prefix 0
      if (j >= 0) {
        do {
          d = ld_acquire(desc + first + j);
        } while ((d >> 32) == 0);
        if (j == c - 1)
          s_prev_tail = static_cast<unsigned>(ld_acquire(tails + tile - 1));
      }
      const unsigned p = __ballot_sync(0xffffffffu, (d >> 32) == 2);
      if (lane == 0) s_prefix_lanes[warp] = p;
      __syncthreads();
      // The nearest tile flagged PREFIX ends the look-back: it and the
      // aggregates after it are summed.
      int stop = kThreads;
#pragma unroll
      for (int w = kWarps - 1; w >= 0; --w) {
        const unsigned pw = s_prefix_lanes[w];
        if (pw) stop = w * 32 + __ffs(pw) - 1;
      }
      unsigned long long add =
          static_cast<int>(threadIdx.x) <= stop ? (d & 0xffffffffull) : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        add += __shfl_xor_sync(0xffffffffu, add, o);
      if (lane == 0) s_sum[warp] = add;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) excl += s_sum[w];
      __syncthreads();  // s_prefix_lanes and s_sum are reused
      if (stop < kThreads) break;
    }
    if (threadIdx.x == 0)
      st_release(desc + tile, kPrefix | (excl + tile_bits));
  }
  const unsigned bit0 = static_cast<unsigned>(excl & 31u);

  // Assemble the tile's words in shared memory: the predecessor's last
  // bit0 bits open the first word. A thread's V codes of a round are
  // consecutive in the stream: a 64-bit bit-writer, primed with the bits of
  // its first word that precede them, ORs each word it completes, and the
  // partial last one. Bits of different codes never overlap, so OR is
  // exact.
  if (threadIdx.x == 0 && bit0 != 0) atomicOr(sw, s_prev_tail << (32 - bit0));
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned pos = bit0 + round_off[r];
    unsigned w = pos >> 5;
    unsigned nb = pos & 31u;  // bits in the buffer, the first nb zeros
    unsigned long long buf = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const unsigned l = len_at(r * V + k);
      buf = (buf << l) | code[r * V + k];
      nb += l;
      if (nb >= 32) {
        nb -= 32;
        atomicOr(sw + w, static_cast<uint32_t>(buf >> nb));
        ++w;
      }
    }
    if (nb) atomicOr(sw + w, static_cast<uint32_t>(buf << (32 - nb)));
  }
  __syncthreads();

  // Plain coalesced stores. A word the tile shares with its successor is
  // the successor's to write; the sample's last tile writes its last word
  // and zeroes the rest of the row.
  const unsigned end = bit0 + tile_bits;
  const bool last = c == chunks - 1;
  const long long n_out = last ? (end + 31) >> 5 : end >> 5;
  const long long gw0 = static_cast<long long>(excl >> 5);
  // The caller sizes w_words from the exact bit totals; the bound only
  // keeps a wrong size from writing past the row.
  const long long g_end = last ? w_words : min(w_words, gw0 + n_out);
  uint32_t* row = words + static_cast<long long>(b) * w_words;
  for (long long g = gw0 + threadIdx.x; g < g_end; g += kThreads) {
    const long long i = g - gw0;
    row[g] = i < n_out ? sw[i] : 0u;
  }
}

}  // namespace

extern "C" {

// Elements per tile; the caller sizes the scratch as (1 + 2 * B * ceil(n /
// jalad_huffman_chunk())) u64.
int jalad_huffman_chunk(void) { return kChunk; }

// K3: x (B, n) f32 (in_bf16 = 0) or bf16, mn/scale (B,), code_lut (B, 2^bits)
// u32 codes, len_lut (B, 2^bits) u8 lengths (<= 32) -> words (B, w_words),
// every word written. scratch: scratch_len >= 1 + 2 * B * chunks u64 (the
// ticket, a descriptor and a tail a tile); smem_bytes: the kernel's dynamic
// shared memory. One memset (ticket and descriptors), one kernel.
int jalad_huffman_pack(const void* x, int in_bf16, int batch, long long n,
                       int bits, const float* mn, const float* scale,
                       const uint32_t* code_lut, const uint8_t* len_lut,
                       int chunks, void* scratch, long long scratch_len,
                       uint32_t* words, long long w_words, int smem_bytes,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_symbols = 1 << bits;
  const float levels = static_cast<float>(n_symbols - 1);
  const long long tiles = static_cast<long long>(batch) * chunks;
  if (1 + 2 * tiles > scratch_len || tiles >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* sc = static_cast<unsigned long long*>(scratch);
  const int grid = static_cast<int>(tiles);
  if (in_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const int vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    huffman_pack_kernel<__nv_bfloat16><<<grid, kThreads, smem_bytes, s>>>(
        xb, n, chunks, vec, mn, scale, code_lut, len_lut, n_symbols, levels,
        sc, words, w_words);
  } else {
    const float* xf = static_cast<const float*>(x);
    const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    huffman_pack_kernel<float><<<grid, kThreads, smem_bytes, s>>>(
        xf, n, chunks, vec, mn, scale, code_lut, len_lut, n_symbols, levels,
        sc, words, w_words);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
