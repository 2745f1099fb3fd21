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
// once; a few integer ops per element). The prefix sum crosses blocks, and
// GPU blocks run in no order, so the carry is a second small pass:
//   1. chunk_bits: each block sums the code lengths of one 4096-element
//      chunk of one sample (coalesced loads, table gather, block sum);
//   2. chunk_scan: one block per sample turns the chunk sums into exclusive
//      chunk offsets and zeroes the sample's output words;
//   3. emit: each block re-quantizes its chunk into shared memory (coalesced
//      loads), each thread scans its 16 consecutive codes, a block scan of
//      the thread totals adds the thread offset, and the thread ORs its
//      codes into a register word, flushing it with atomicOr when the word
//      changes. Bits of different codes never overlap, so OR is exact and
//      the order of the atomics does not matter.
// The input is read twice (passes 1 and 3); the quantized codes never reach
// device memory. The TPU kernel's sorted-segment emission and symbol folding
// worked around XLA-CPU scatter and TPU scan costs and are not needed here.
//
// Numerics: the quantize uses the _rn intrinsics and rintf, bit-identical to
// the reference quantize, so the codes match the host histogram exactly.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // elements per block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ unsigned quant_code(float v, float mn, float scale,
                                               float levels) {
  float q = rintf(__fmul_rn(__fsub_rn(v, mn), scale));
  q = fminf(fmaxf(q, 0.0f), levels);
  return static_cast<unsigned>(q);
}

// Inclusive scan over the block (blockDim.x a multiple of 32, <= 1024);
// *total receives the block's sum. Safe to call repeatedly.
__device__ __forceinline__ int block_inclusive_scan(int v, int* total) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int result = v + (warp > 0 ? s_warp[warp - 1] : 0);
  *total = s_warp[n_warps - 1];
  __syncthreads();
  return result;
}

// Pass 1: grid (chunks, B). chunk_bits[b * chunks + c] = total code length
// of chunk c of sample b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_bits_kernel(const T* __restrict__ x, long long n,
                  const float* __restrict__ mn, const float* __restrict__ scale,
                  const uint8_t* __restrict__ len_lut, int n_symbols,
                  float levels, int* __restrict__ chunk_bits) {
  const int b = blockIdx.y;
  const float m = mn[b];
  const float s = scale[b];
  const T* xs = x + static_cast<long long>(b) * n;
  const uint8_t* lens = len_lut + static_cast<long long>(b) * n_symbols;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  int sum = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = start + k * kThreads + threadIdx.x;
    if (i < n) sum += lens[quant_code(load_f32(xs, i), m, s, levels)];
  }
  int total;
  block_inclusive_scan(sum, &total);
  if (threadIdx.x == 0) chunk_bits[b * gridDim.x + blockIdx.x] = total;
}

// Pass 2: grid (B,), kScanThreads threads. In place: chunk sums -> exclusive
// chunk offsets. Also zeroes the sample's w_words output words.
__global__ void __launch_bounds__(kScanThreads)
chunk_scan_kernel(int* __restrict__ chunk_bits, int chunks,
                  uint32_t* __restrict__ words, long long w_words) {
  const int b = blockIdx.x;
  int* cb = chunk_bits + static_cast<long long>(b) * chunks;
  int carry = 0;
  for (int base = 0; base < chunks; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < chunks ? cb[i] : 0;
    int total;
    const int incl = block_inclusive_scan(v, &total);
    if (i < chunks) cb[i] = carry + incl - v;
    carry += total;
  }
  uint32_t* ws = words + static_cast<long long>(b) * w_words;
  for (long long w = threadIdx.x; w < w_words; w += blockDim.x) ws[w] = 0u;
}

// Pass 3: grid (chunks, B). Emits chunk c of sample b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const T* __restrict__ x, long long n, const float* __restrict__ mn,
            const float* __restrict__ scale,
            const uint32_t* __restrict__ code_lut,
            const uint8_t* __restrict__ len_lut, int n_symbols, float levels,
            const int* __restrict__ chunk_off, uint32_t* __restrict__ words,
            long long w_words) {
  __shared__ uint32_t s_code[kChunk];
  __shared__ uint8_t s_len[kChunk];
  const int b = blockIdx.y;
  const float m = mn[b];
  const float s = scale[b];
  const T* xs = x + static_cast<long long>(b) * n;
  const uint32_t* codes = code_lut + static_cast<long long>(b) * n_symbols;
  const uint8_t* lens = len_lut + static_cast<long long>(b) * n_symbols;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  for (int k = 0; k < kPerThread; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const long long i = start + j;
    if (i < n) {
      const unsigned q = quant_code(load_f32(xs, i), m, s, levels);
      s_code[j] = codes[q];
      s_len[j] = lens[q];
    } else {
      s_code[j] = 0u;
      s_len[j] = 0;
    }
  }
  __syncthreads();
  const int first = threadIdx.x * kPerThread;
  int mine = 0;
  for (int k = 0; k < kPerThread; ++k) mine += s_len[first + k];
  int total;
  const int incl = block_inclusive_scan(mine, &total);
  long long pos = static_cast<long long>(chunk_off[b * gridDim.x + blockIdx.x]) +
                  (incl - mine);
  uint32_t* ws = words + static_cast<long long>(b) * w_words;
  long long cur = -1;
  uint32_t acc = 0u;
  for (int k = 0; k < kPerThread; ++k) {
    const int len = s_len[first + k];
    if (len == 0) continue;
    const uint32_t c = s_code[first + k];
    const long long w = pos >> 5;
    const int o = static_cast<int>(pos & 31);
    if (w != cur) {
      if (cur >= 0 && cur < w_words) atomicOr(ws + cur, acc);
      cur = w;
      acc = 0u;
    }
    if (o + len <= 32) {
      acc |= c << (32 - o - len);
    } else {
      const int spill = o + len - 32;  // 1..31 bits go to the next word
      if (w < w_words) atomicOr(ws + w, acc | (c >> spill));
      cur = w + 1;
      acc = c << (32 - spill);
    }
    pos += len;
  }
  // The caller sizes w_words from the exact bit totals; the bound checks
  // only keep a wrong size from writing past the row.
  if (cur >= 0 && cur < w_words) atomicOr(ws + cur, acc);
}

template <typename T>
int launch_pack(const T* x, int batch, long long n, int bits,
                const float* mn, const float* scale, const uint32_t* code_lut,
                const uint8_t* len_lut, int chunks, int* chunk_bits,
                uint32_t* words, long long w_words, cudaStream_t stream) {
  const int n_symbols = 1 << bits;
  const float levels = static_cast<float>(n_symbols - 1);
  const dim3 grid(chunks, batch);
  chunk_bits_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, n, mn, scale, len_lut, n_symbols, levels, chunk_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_scan_kernel<<<batch, kScanThreads, 0, stream>>>(chunk_bits, chunks,
                                                         words, w_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, n, mn, scale, code_lut, len_lut, n_symbols, levels, chunk_bits,
      words, w_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements per pass-1/pass-3 block; the caller sizes chunk_bits as
// (B, ceil(n / jalad_huffman_chunk())).
int jalad_huffman_chunk(void) { return kChunk; }

// K3: x (B, n) f32 (in_bf16 = 0) or bf16, mn/scale (B,), code_lut (B, 2^bits)
// u32 codes, len_lut (B, 2^bits) u8 lengths (<= 32) -> words (B, w_words).
// Three launches.
int jalad_huffman_pack(const void* x, int in_bf16, int batch, long long n,
                       int bits, const float* mn, const float* scale,
                       const uint32_t* code_lut, const uint8_t* len_lut,
                       int chunks, int* chunk_bits, uint32_t* words,
                       long long w_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_pack(static_cast<const __nv_bfloat16*>(x), batch, n, bits,
                       mn, scale, code_lut, len_lut, chunks, chunk_bits, words,
                       w_words, s);
  }
  return launch_pack(static_cast<const float*>(x), batch, n, bits, mn, scale,
                     code_lut, len_lut, chunks, chunk_bits, words, w_words, s);
}

}  // extern "C"
