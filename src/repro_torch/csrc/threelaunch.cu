// The three-launch edge encode for Hopper (sm_90a): K6a, K6b and K6c.
//
// This is the reference's first edge encode, kept beside the fused K1 of
// quantize.cu as its byte-identity baseline: the same codes, made in three
// passes with the codes written to device memory and read back between the
// quantize and the pack. Each kernel works on the flat n elements of one
// tensor; the TPU's (M, 128) tiling and its padding have no use here. The
// three kernels are the chain's only device work besides its allocations.
//
// K6a  range — replaces repro/kernels/quantize/quantize.py `minmax_blocks`
//      (Pallas `_minmax_kernel` and the jnp.min / jnp.max fold of its
//      block partials): an f32 or bf16 input -> its (min, max) as two f32,
//      in the reference's order -0.0 < +0.0 (ranges.cuh). Bound: the input
//      read once plus 8 bytes written (12.85 MB at the ResNet-50 stem
//      boundary at batch 4: 3.84 us at 3.35 TB/s).
// K6b  quantize — replaces `quantize_blocks` (`_quantize_kernel` and the
//      scale computed beside it): scale = (2^c - 1) / (mx - mn), 0 where
//      mx == mn, then q = clip(rint((x - mn) * scale), 0, 2^c - 1), u8
//      codes at c <= 8, u16 above. (mn, mx) are read through pointers, so
//      the host never waits for the range. Bound: the input and 8 bytes
//      read, the codes written (4.79 us at 8 bits at the stem, 5.75 us at
//      16 bits).
// K6c  nibble pack — replaces `pack4_blocks` (`_pack4_kernel`), at c <= 4
//      only: byte i = codes[2i] | codes[2i + 1] << 4, truncated to 8 bits
//      as the reference's u8 shift truncates (codes >= 16 included); an odd
//      count repeats codes[0] in the last high nibble, as the reference pads
//      its tiles with the first element. Bound: codes read + bytes written
//      (3.21 + 1.61 MB at the stem boundary at batch 4: 1.44 us).
//
// All three move a few bytes per flop, so bytes bound them. K6a and K6b
// read 16 bytes a load (4 f32 or 8 bf16), 4 loads a thread in flight,
// over a grid (K6b at most 1,056 blocks, 132 SMs x 8) that steps over the
// whole input; where the flat input does not start on a 16-byte boundary,
// the first block reads the head and the tail elements one by one. K6a
// leaves the input in L2 for K6b where it fits (the stem's 12.85 MB does).
// K6a folds on integer order keys (one redux.sync a warp). Above 32 KB of
// input (ops.py K6A_SOLO_BYTES) it is a cooperative launch of two blocks
// an SM: each block writes its key pair to the call's own scratch, the
// grid syncs, and block 0 folds every pair and writes (mn, mx); below, one
// block and a plain launch. A last-block-done ticket would need zeroing
// before every call: with its memset K6a took 15.6 us cold at the stem on
// the H100, 13.2 as it is (scripts/time_codec_kernels.py). K6b computes
// its scale once a thread with IEEE division (__fdiv_rn), as the reference
// divides tensor by tensor, rounds by a float add (quant_code, codes.cuh)
// instead of the conversion pipe, and stores the codes of a load as one
// word (4 to 16 bytes); where the codes do not start aligned as the input
// does, it stores them one by one.
// K6c reads 16 codes a load and stores their 8 bytes as one word, kUnroll
// loads a thread in flight over K6b's grid, so a warp moves whole 128-byte
// lines (512 bytes in, 256 out, an instruction); a tail of fewer than 16
// codes is packed one byte a thread by the first threads of the grid. Codes
// that do not start on a 16-byte boundary (a view into a larger tensor; the
// chain always hands K6c a fresh allocation) take a byte-wise branch of the
// same kernel, one output byte a thread, rather than wide loads that would
// read bytes outside the tensor.
//
// Numerics: __fsub_rn / __fmul_rn are never contracted into an FMA, and
// quant_code rounds half to even as jnp.round does, so the codes are the
// bits of K1's and of the reference's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "ranges.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// 16-byte loads a K6a / K6b / K6c thread has in flight (ops.py _grid's 4
// items a thread).
constexpr int kUnroll = 4;

// The scalar head of the flat input x of n elements: the elements before
// its first 16-byte boundary (at most n).
template <typename T>
__device__ __forceinline__ long long head_elems(const T* x, long long n) {
  const long long h =
      ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / sizeof(T);
  return h < n ? h : n;
}

// The element the first block's thread t takes one by one: the head [0, h)
// and then the tail [body_end, n); -1 where there is none.
__device__ __forceinline__ long long edge_elem(long long h, long long body_end,
                                               long long n) {
  const long long t = threadIdx.x;
  const long long e = t < h ? t : body_end + (t - h);
  return blockIdx.x == 0 && e < n ? e : -1;
}

// K6a: grid (blocks) over the n elements: one block (SYNC false, a plain
// launch) or a cooperative grid. partials: one key pair a block. mn_mx:
// the folded (min, max).
template <typename T, bool SYNC>
__global__ void __launch_bounds__(kThreads)
minmax_kernel(const T* __restrict__ x, long long n,
              int2* __restrict__ partials, float* __restrict__ mn_mx) {
  constexpr int V = In<T>::kVec;
  const long long h = head_elems(x, n);
  const long long nv = (n - h) / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + h);
  KeyRange r;
  const long long e = edge_elem(h, h + nv * V, n);
  if (e >= 0) r.add(load_f32(x, e));
  const long long step = static_cast<long long>(gridDim.x) * kThreads *
                         kUnroll;
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads *
                          kUnroll + threadIdx.x;
       v0 < nv; v0 += step) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nv) w[u] = xv[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < nv) fold_vec<T>(w[u], r);
  }
  block_range(r);
  if constexpr (SYNC) {
    if (threadIdx.x == 0) partials[blockIdx.x] = make_int2(r.lo, r.hi);
    cg::this_grid().sync();
    if (blockIdx.x != 0) return;
    // Two pairs a thread in flight.
    const int parts = static_cast<int>(gridDim.x);
    KeyRange all;
    for (int i = threadIdx.x; i < parts; i += 2 * kThreads) {
      const int j = i + kThreads;
      const int2 p = __ldcg(partials + i);
      const int2 q = j < parts ? __ldcg(partials + j)
                               : make_int2(kKeyPosInf, kKeyNegInf);
      all.add(p.x, p.y);
      all.add(q.x, q.y);
    }
    block_range(all);
    r = all;
  }
  if (threadIdx.x == 0) {
    mn_mx[0] = r.min_value();
    mn_mx[1] = r.max_value();
  }
}

template <typename T>
int launch_minmax(const T* x, long long n, int blocks, int2* partials,
                  float* mn_mx, cudaStream_t stream) {
  if (blocks == 1) {
    minmax_kernel<T, false><<<1, kThreads, 0, stream>>>(x, n, partials,
                                                        mn_mx);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&x, &n, &partials, &mn_mx};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(minmax_kernel<T, true>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
  // A refused launch is reported once, here: clear it so that the next
  // launch's check does not see it again.
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Blocks an SM of K6a's cooperative grid: on the H100 two 256-thread
// blocks an SM (264) read the stem boundary faster, cold and warm, than
// the 784 that cover it in one round (13.2 against 14.4 us cold), and
// leave block 0 264 pairs to fold.
constexpr int kMinmaxBlocksPerSm = 2;

template <typename T>
int minmax_resident(int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, minmax_kernel<T, true>, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = (per_sm < kMinmaxBlocksPerSm ? per_sm : kMinmaxBlocksPerSm) * sms;
  return static_cast<int>(err);
}

// V codes stored at o: one 4-, 8- or 16-byte word where o is aligned to it,
// else one by one.
template <typename OutT, int V>
__device__ __forceinline__ void store_codes(OutT* o, const unsigned (&q)[V],
                                            bool aligned) {
  if (!aligned) {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = static_cast<OutT>(q[i]);
    return;
  }
  constexpr int kPer = 4 / sizeof(OutT);        // codes a 32-bit word
  constexpr int kWords = V / kPer;
  unsigned w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    w[k] = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      w[k] |= q[k * kPer + i] << (8 * sizeof(OutT) * i);
  }
  if constexpr (kWords == 1) {
    *reinterpret_cast<uint32_t*>(o) = w[0];
  } else if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// K6b: grid (blocks) over the n codes. OutT is uint8_t or uint16_t.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long n,
                const float* __restrict__ mn_p,
                const float* __restrict__ mx_p, float levels,
                OutT* __restrict__ codes) {
  constexpr int V = In<T>::kVec;
  const float mn = *mn_p;
  const float mx = *mx_p;
  const float scale = mx > mn ? __fdiv_rn(levels, __fsub_rn(mx, mn)) : 0.0f;
  const long long h = head_elems(x, n);
  const long long nv = (n - h) / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + h);
  // Group v's codes start at element h + v * V: aligned to their word where
  // the input starts on a 16-byte boundary and the codes on a word.
  const bool aligned =
      h == 0 && (reinterpret_cast<uintptr_t>(codes) % (V * sizeof(OutT))) == 0;
  const long long e = edge_elem(h, h + nv * V, n);
  if (e >= 0) {
    codes[e] = static_cast<OutT>(quant_code(load_f32(x, e), mn, scale,
                                            levels));
  }
  const long long step = static_cast<long long>(gridDim.x) * kThreads *
                         kUnroll;
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads *
                          kUnroll + threadIdx.x;
       v0 < nv; v0 += step) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nv) w[u] = xv[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nv) {
        float f[V];
        In<T>::unpack(w[u], f);
        unsigned q[V];
#pragma unroll
        for (int i = 0; i < V; ++i) q[i] = quant_code(f[i], mn, scale, levels);
        store_codes<OutT, V>(codes + h + v * V, q, aligned);
      }
    }
  }
}

// 16 codes (one 16-byte load) -> their 8 packed bytes (one 8-byte store).
// In each word, bytes 0 and 2 become lo | hi << 4 truncated to 8 bits (the
// high nibble is the low nibble of hi, as the reference's u8 shift leaves
// it); __byte_perm then gathers those bytes of two words into one.
__device__ __forceinline__ uint2 pack16(const uint4& c) {
  const unsigned p0 = (c.x & 0x00FF00FFu) | ((c.x >> 4) & 0x00F000F0u);
  const unsigned p1 = (c.y & 0x00FF00FFu) | ((c.y >> 4) & 0x00F000F0u);
  const unsigned p2 = (c.z & 0x00FF00FFu) | ((c.z >> 4) & 0x00F000F0u);
  const unsigned p3 = (c.w & 0x00FF00FFu) | ((c.w >> 4) & 0x00F000F0u);
  return make_uint2(__byte_perm(p0, p1, 0x6420), __byte_perm(p2, p3, 0x6420));
}

// K6c: grid (blocks) over the n codes -> out_n = ceil(n / 2) bytes.
__global__ void __launch_bounds__(kThreads)
pack4_blocks_kernel(const uint8_t* __restrict__ codes, long long n,
                    uint8_t* __restrict__ out, long long out_n) {
  // Out bytes [first, out_n) are made one by one: the tail of fewer than 16
  // codes where the codes start on a 16-byte boundary, else every byte.
  long long first = 0;
  if (((reinterpret_cast<uintptr_t>(codes) & 15) |
       (reinterpret_cast<uintptr_t>(out) & 7)) == 0) {
    const long long nv = n / 16;
    const uint4* cv = reinterpret_cast<const uint4*>(codes);
    uint2* ov = reinterpret_cast<uint2*>(out);
    const long long step = static_cast<long long>(gridDim.x) * kThreads *
                           kUnroll;
    for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads *
                            kUnroll + threadIdx.x;
         v0 < nv; v0 += step) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * kThreads;
        if (v < nv) w[u] = cv[v];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * kThreads;
        if (v < nv) ov[v] = pack16(w[u]);
      }
    }
    first = 8 * nv;
  }
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = first + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < out_n; j += threads) {
    const long long i1 = 2 * j + 1;
    const unsigned lo = codes[2 * j];
    const unsigned hi = codes[i1 < n ? i1 : 0];
    out[j] = static_cast<uint8_t>(lo | (hi << 4));
  }
}

template <typename T>
int launch_quantize(const T* x, long long n, const float* mn, const float* mx,
                    int bits, void* codes, int blocks, cudaStream_t stream) {
  const float levels = static_cast<float>((1u << bits) - 1u);
  if (bits <= 8) {
    quantize_kernel<T, uint8_t><<<blocks, kThreads, 0, stream>>>(
        x, n, mn, mx, levels, static_cast<uint8_t*>(codes));
  } else {
    quantize_kernel<T, uint16_t><<<blocks, kThreads, 0, stream>>>(
        x, n, mn, mx, levels, static_cast<uint16_t*>(codes));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6a: x (n,) f32 (in_bf16 = 0) or bf16 -> mn_mx (2,) f32. partials:
// (blocks,) int2 scratch; blocks at most jalad_minmax_resident's. One
// launch: a plain one at blocks = 1, else cooperative.
int jalad_minmax_blocks(const void* x, int in_bf16, long long n, int blocks,
                        void* partials, float* mn_mx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* p = static_cast<int2*>(partials);
  if (in_bf16) {
    return launch_minmax(static_cast<const __nv_bfloat16*>(x), n, blocks, p,
                         mn_mx, s);
  }
  return launch_minmax(static_cast<const float*>(x), n, blocks, p, mn_mx, s);
}

// Blocks of K6a's cooperative grid on the current card: those it holds at
// once, at most kMinmaxBlocksPerSm an SM.
int jalad_minmax_resident(int in_bf16, int* blocks) {
  return in_bf16 ? minmax_resident<__nv_bfloat16>(blocks)
                 : minmax_resident<float>(blocks);
}

// K6b: x (n,) f32 or bf16 + device scalars mn, mx -> codes (n,) u8
// (bits <= 8) or u16. One launch.
int jalad_quantize_blocks(const void* x, int in_bf16, long long n,
                          const float* mn, const float* mx, int bits,
                          void* codes, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_quantize(static_cast<const __nv_bfloat16*>(x), n, mn, mx,
                           bits, codes, blocks, s);
  }
  return launch_quantize(static_cast<const float*>(x), n, mn, mx, bits,
                         codes, blocks, s);
}

// K6c: codes (n,) u8 -> out (out_n,) u8, out_n = ceil(n / 2); blocks cover
// ceil(n / 16) 16-byte loads. One launch.
int jalad_pack4_blocks(const uint8_t* codes, long long n, uint8_t* out,
                       long long out_n, int blocks, void* stream) {
  pack4_blocks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(codes, n, out,
                                                            out_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
