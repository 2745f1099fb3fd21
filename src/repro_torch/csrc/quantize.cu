// Boundary-codec quantize kernels for Hopper (sm_90a): K1 and K2.
//
// K1  fused encode  — replaces repro/kernels/quantize/quantize.py
//     `fused_encode_blocks` (Pallas `_fused_encode_whole_kernel` /
//     `_fused_encode_kernel`). Per-sample min/max (in the reference's order,
//     -0.0 < +0.0: ranges.cuh), then
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
// (bytes in + bytes out) / 3.35 TB/s.
//
// K1 is one launch that reads its input from device memory once wherever
// the stack fits on chip. A sample's range must be known before any of its
// codes, and blocks run in no order, so each block stages a contiguous
// share of one sample in shared memory (16-byte loads) while it reduces the
// share's (min, max); the blocks of a sample then exchange their pairs, and
// each quantizes its share from shared memory and stores the codes 4 or 8
// bytes a thread (a warp's store covers 128 or 256 contiguous bytes). The
// exchange is the variant (`fused_encode_plan` in kernels/quantize/ops.py
// picks it by size):
//   solo     one block a sample: no exchange, a plain launch (small samples,
//            e.g. fc and the odd tensor, or more samples than the card
//            holds blocks);
//   grid     a cooperative launch of at most as many blocks as the card
//            holds at once, split evenly over the samples: each block writes
//            its pair to scratch, cg::this_grid().sync(), then warp 0 folds
//            only its own sample's pairs (at most a few hundred).
// A block is 512 threads with at most 200 KB of shared memory, one to an
// SM: 132 of them stage ~26 MB, so the stem boundary and the pipeline's
// (4, 802,816) stack are read once. Where a share is longer than its block
// stages, the rest is read a second time after the exchange (from L2 where
// it fits), in the same launch. The range folds on integer order keys
// (ranges.cuh; one redux.sync a warp) and the codes round by a float add
// (quant_code, codes.cuh): with a compare-and-select fold and rintf /
// float-to-int conversions both phases are instruction-bound on the H100
// and take about twice as long warm.
// Shares start on multiples of 64 elements, so no code byte is split
// between blocks at <= 4 bits; the block that owns a sample's last byte at
// odd n reads element 0 for the repeated high nibble. A share's staged
// copy keeps the input's 16-byte phase, so the loads are whole vectors
// with scalar head and tail elements; where the codes of a row of a B-stack
// are not aligned as its input is (odd n), the staged reads go one by one.
//
// K2 is one launch and one pass: every code byte read once,
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
// (never contracted, never fast-math); K1 rounds the clipped code by a float
// add of 1.5 * 2^23 (quant_code: half to even, as jnp.round, exact for
// every code of at most 16 bits), so codes are bit-identical to the
// reference; the decode uses one fmaf so it rounds once, as the
// reference's jitted decode does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "codes.cuh"
#include "ranges.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// Threads of a K1 block, and the 16-byte loads a thread has in flight.
constexpr int kEncThreads = 512;
constexpr int kEncUnroll = 4;
// Shares start on multiples of this many elements (ops.py FE_SHARE_UNIT).
constexpr long long kShareUnit = 64;
// Variants (ops.py FE_VARIANTS).
constexpr int kSolo = 0;
constexpr int kGrid = 1;

// A thread's group of K1 outputs: kElems elements whose kUnits codes are
// one store. MODE 0: 8 elements -> 4 nibble-packed bytes; MODE 1: 8
// elements -> 8 u8 codes; MODE 2: 4 elements -> 4 u16 codes (8 bytes).
template <int MODE>
struct Group {
  static constexpr int kElems = MODE == 2 ? 4 : 8;
  static constexpr int kUnits = MODE == 0 ? 4 : kElems;
};

// kE staged elements from s + p as floats: vector reads where p is aligned
// to them (16 bytes, or 8 for four bf16), else one by one.
template <int kE>
__device__ __forceinline__ void read_staged(const float* s, long long p,
                                            bool aligned, float (&v)[kE]) {
  if (aligned) {
#pragma unroll
    for (int i = 0; i < kE; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(s + p + i);
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i) v[i] = s[p + i];
  }
}

template <int kE>
__device__ __forceinline__ void read_staged(const __nv_bfloat16* s,
                                            long long p, bool aligned,
                                            float (&v)[kE]) {
  if (aligned) {
    unsigned w[kE / 2];
    if constexpr (kE == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(s + p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(s + p);
      w[0] = q.x; w[1] = q.y;
    }
#pragma unroll
    for (int i = 0; i < kE / 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i) v[i] = __bfloat162float(s[p + i]);
  }
}

// The codes of one group, stored at o (aligned to the store: 4 bytes at
// MODE 0, else 8).
template <int MODE>
__device__ __forceinline__ void store_group(void* o, const unsigned (&q)[8]) {
  if (MODE == 0) {
    *static_cast<uint32_t*>(o) =
        (q[0] | q[1] << 4) | (q[2] | q[3] << 4) << 8 |
        (q[4] | q[5] << 4) << 16 | (q[6] | q[7] << 4) << 24;
  } else if (MODE == 1) {
    *static_cast<uint2*>(o) =
        make_uint2(q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24,
                   q[4] | q[5] << 8 | q[6] << 16 | q[7] << 24);
  } else {
    *static_cast<uint2*>(o) = make_uint2(q[0] | q[1] << 16,
                                         q[2] | q[3] << 16);
  }
}

// K1: grid (B * k) of kEncThreads threads; block g owns share r = g % k of
// sample b = g / k: elements [e0, e1) with e_r = (r * units / k) *
// kShareUnit, units = n / kShareUnit, and e_k = n. The first `cap`
// elements of the staged layout (element e at p = e - base, which keeps
// the input's phase mod 8) live in dynamic shared memory; elements past
// cap are read again after the exchange. partials: (B * k) int2 scratch
// of order keys (kGrid only, every slot written before the grid barrier).
template <typename T, int MODE, int SYNC>
__global__ void __launch_bounds__(kEncThreads, 1)
fused_encode_kernel(const T* __restrict__ x, long long n, int k,
                    long long cap, float levels, int2* __restrict__ partials,
                    float* __restrict__ mn_out, float* __restrict__ mx_out,
                    void* __restrict__ out, long long out_n) {
  constexpr int V = In<T>::kVec;
  using G = Group<MODE>;
  constexpr int E = G::kElems;
  // Elements a staged vector read takes at once: 16 bytes, at most E.
  constexpr int AE = (E * sizeof(T) < 16 ? E * sizeof(T) : 16) / sizeof(T);
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s = reinterpret_cast<T*>(s_raw);

  const int b = blockIdx.x / k;
  const int r = blockIdx.x - b * k;
  const long long units = n / kShareUnit;
  const long long e0 = r * units / k * kShareUnit;
  const long long e1 = r == k - 1 ? n : (r + 1) * units / k * kShareUnit;
  const T* xs = x + static_cast<long long>(b) * n;
  const long long ph =
      static_cast<long long>(reinterpret_cast<uintptr_t>(xs) / sizeof(T)) & 7;
  const long long base = ((ph + e0) & ~7ll) - ph;

  // Phase 1: the share's (min, max), staging its first cap - (e0 - base)
  // elements. Whole 16-byte vectors [va, va + nv * V), kEncUnroll loads a
  // thread in flight; scalar head [e0, va) and tail elements, loaded
  // before the first vector is folded.
  KeyRange range;
  const long long va = min(e1, e0 + (V - (ph + e0) % V) % V);
  const long long nv = (e1 - va) / V;
  const long long body_end = va + nv * V;
  const long long n_edge = (va - e0) + (e1 - body_end);
  long long e_edge = -1;
  T t_edge;
  if (threadIdx.x < n_edge) {
    e_edge = threadIdx.x < va - e0 ? e0 + threadIdx.x
                                   : body_end + (threadIdx.x - (va - e0));
    t_edge = xs[e_edge];
  }
  const long long stride = static_cast<long long>(blockDim.x) * kEncUnroll;
  for (long long v0 = threadIdx.x; v0 < nv; v0 += stride) {
    uint4 w[kEncUnroll];
#pragma unroll
    for (int u = 0; u < kEncUnroll; ++u) {
      const long long v = v0 + static_cast<long long>(u) * blockDim.x;
      if (v < nv) w[u] = *reinterpret_cast<const uint4*>(xs + va + v * V);
    }
#pragma unroll
    for (int u = 0; u < kEncUnroll; ++u) {
      const long long v = v0 + static_cast<long long>(u) * blockDim.x;
      if (v < nv) {
        fold_vec<T>(w[u], range);
        const long long p = va + v * V - base;
        if (p < cap) *reinterpret_cast<uint4*>(s + p) = w[u];
      }
    }
  }
  if (e_edge >= 0) {
    range.add(load_f32(&t_edge, 0));
    if (e_edge - base < cap) s[e_edge - base] = t_edge;
  }
  block_range(range);

  // The exchange: the sample's range from its k blocks' pairs, folded by
  // warp 0 and handed to the block through shared memory.
  __shared__ int2 s_all;
  if constexpr (SYNC == kGrid) {
    if (threadIdx.x == 0) partials[blockIdx.x] = make_int2(range.lo, range.hi);
    cg::this_grid().sync();
    if (threadIdx.x < 32) {
      KeyRange all;
      for (int i = threadIdx.x; i < k; i += 32) {
        const int2 pr = __ldcg(partials + static_cast<long long>(b) * k + i);
        all.add(pr.x, pr.y);
      }
      warp_range(all);
      if (threadIdx.x == 0) s_all = make_int2(all.lo, all.hi);
    }
    __syncthreads();
    range.lo = s_all.x;
    range.hi = s_all.y;
  }
  const float lo = range.min_value();
  const float hi = range.max_value();
  if (r == 0 && threadIdx.x == 0) {
    mn_out[b] = lo;
    mx_out[b] = hi;
  }
  const float scale = hi > lo ? __fdiv_rn(levels, __fsub_rn(hi, lo)) : 0.0f;

  // Phase 2: the share's codes. Output units (bytes at MODE 0, codes
  // else) [j0, j1); groups of G::kUnits units start where their store is
  // aligned, at element eg; the units before (head) and after (tail) them
  // go one a thread.
  const long long row = static_cast<long long>(b) * out_n;
  const long long j0 = MODE == 0 ? e0 / 2 : e0;
  const long long j1 = MODE == 0 ? (e1 + 1) / 2 : e1;
  const long long jg =
      min(j1, j0 + (G::kUnits - (row + j0) % G::kUnits) % G::kUnits);
  const long long eg = MODE == 0 ? 2 * jg : jg;
  const long long ng = e1 > eg ? (e1 - eg) / E : 0;
  const bool aligned = (eg - base) % AE == 0;
  using Unit = typename std::conditional<MODE == 2, uint16_t, uint8_t>::type;
  Unit* o = static_cast<Unit*>(out) + row;
  for (long long g = threadIdx.x; g < ng; g += blockDim.x) {
    const long long e = eg + g * E;
    const long long p = e - base;
    float v[E];
    if (p + E <= cap) {
      read_staged<E>(s, p, aligned, v);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i)
        v[i] = p + i < cap ? load_f32(s, p + i) : load_f32(xs, e + i);
    }
    unsigned q[8];
#pragma unroll
    for (int i = 0; i < E; ++i) q[i] = quant_code(v[i], lo, scale, levels);
    store_group<MODE>(o + jg + g * G::kUnits, q);
  }
  const long long jt = jg + ng * G::kUnits;
  const long long n_units = (jg - j0) + (j1 - jt);
  if (threadIdx.x < n_units) {
    const long long j = threadIdx.x < jg - j0 ? j0 + threadIdx.x
                                              : jt + (threadIdx.x - (jg - j0));
    // Element e of the sample: staged where it is, else from x.
    auto elem = [&](long long e) {
      return e >= e0 && e < e1 && e - base < cap ? load_f32(s, e - base)
                                                 : load_f32(xs, e);
    };
    if (MODE == 0) {
      const unsigned q0 = quant_code(elem(2 * j), lo, scale, levels);
      const unsigned q1 =
          quant_code(elem(2 * j + 1 < n ? 2 * j + 1 : 0), lo, scale, levels);
      o[j] = static_cast<Unit>(q0 | q1 << 4);
    } else {
      o[j] = static_cast<Unit>(quant_code(elem(j), lo, scale, levels));
    }
  }
}

template <typename T, int MODE, int SYNC>
int launch_encode(const T* x, int batch, long long n, int k, long long cap,
                  int smem_bytes, float levels, int2* partials, float* mn,
                  float* mx, void* out, long long out_n,
                  cudaStream_t stream) {
  auto kernel = fused_encode_kernel<T, MODE, SYNC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * k);
  if constexpr (SYNC == kGrid) {
    void* args[] = {&x, &n, &k, &cap, &levels, &partials, &mn, &mx, &out,
                    &out_n};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                      dim3(kEncThreads), args, smem_bytes,
                                      stream);
  } else {
    kernel<<<grid, kEncThreads, smem_bytes, stream>>>(
        x, n, k, cap, levels, partials, mn, mx, out, out_n);
  }
  // A refused launch is reported once, here: clear it so that the next
  // launch's check does not see it again.
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T, int MODE>
int encode_variant(int variant, const T* x, int batch, long long n, int k,
                   long long cap, int smem_bytes, float levels,
                   int2* partials, float* mn, float* mx, void* out,
                   long long out_n, cudaStream_t s) {
  if (variant == kSolo)
    return launch_encode<T, MODE, kSolo>(x, batch, n, k, cap, smem_bytes,
                                         levels, partials, mn, mx, out, out_n,
                                         s);
  return launch_encode<T, MODE, kGrid>(x, batch, n, k, cap, smem_bytes,
                                       levels, partials, mn, mx, out, out_n,
                                       s);
}

template <typename T>
int encode_dispatch(int variant, const T* x, int batch, long long n,
                    int bits, int k, long long cap, int smem_bytes,
                    int2* partials, float* mn, float* mx, void* out,
                    long long out_n, cudaStream_t s) {
  const float levels = static_cast<float>((1u << bits) - 1u);
  if (bits <= 4)
    return encode_variant<T, 0>(variant, x, batch, n, k, cap, smem_bytes,
                                levels, partials, mn, mx, out, out_n, s);
  if (bits <= 8)
    return encode_variant<T, 1>(variant, x, batch, n, k, cap, smem_bytes,
                                levels, partials, mn, mx, out, out_n, s);
  return encode_variant<T, 2>(variant, x, batch, n, k, cap, smem_bytes,
                              levels, partials, mn, mx, out, out_n, s);
}

// Blocks of the grid variant of (T, MODE) the card holds at once with
// smem_bytes of dynamic shared memory each.
template <typename T, int MODE>
int resident_blocks(int smem_bytes, int* blocks) {
  auto kernel = fused_encode_kernel<T, MODE, kGrid>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kEncThreads, smem_bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

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

// K1: x (B, n) f32 (in_bf16 = 0) or bf16 -> out (B, out_n) codes (16-byte
// aligned), mn / mx (B,). One launch of B * k blocks: variant 0 (solo, k =
// 1) or 1 (cooperative grid; partials holds B * k int2). Each block stages cap elements (a multiple of 8) in
// smem_bytes of dynamic shared memory. The host sizes all of them
// (kernels/quantize/ops.py fused_encode_plan).
int jalad_fused_encode(const void* x, int in_bf16, int batch, long long n,
                       int bits, int variant, int k, long long cap,
                       int smem_bytes, float* partials, float* mn, float* mx,
                       void* out, long long out_n, void* stream) {
  const long long esize = in_bf16 ? 2 : 4;
  const bool k_ok =
      variant == kSolo ? k == 1 : variant == kGrid && k >= 1;
  if (!k_ok || batch < 1 || n < 1 || bits < 1 || bits > 16 || cap < 8 ||
      cap % 8 != 0 || smem_bytes < cap * esize ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(partials) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* pairs = reinterpret_cast<int2*>(partials);
  if (in_bf16) {
    return encode_dispatch(variant, static_cast<const __nv_bfloat16*>(x),
                           batch, n, bits, k, cap, smem_bytes, pairs, mn, mx,
                           out, out_n, s);
  }
  return encode_dispatch(variant, static_cast<const float*>(x), batch, n,
                         bits, k, cap, smem_bytes, pairs, mn, mx, out, out_n,
                         s);
}

// K1's grid variant: blocks the card holds at once for x of in_bf16 at
// bits, with smem_bytes of dynamic shared memory a block, into *blocks.
int jalad_fused_encode_resident(int in_bf16, int bits, int smem_bytes,
                                int* blocks) {
  if (in_bf16) {
    using B = __nv_bfloat16;
    if (bits <= 4) return resident_blocks<B, 0>(smem_bytes, blocks);
    if (bits <= 8) return resident_blocks<B, 1>(smem_bytes, blocks);
    return resident_blocks<B, 2>(smem_bytes, blocks);
  }
  if (bits <= 4) return resident_blocks<float, 0>(smem_bytes, blocks);
  if (bits <= 8) return resident_blocks<float, 1>(smem_bytes, blocks);
  return resident_blocks<float, 2>(smem_bytes, blocks);
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
