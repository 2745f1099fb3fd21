// The int8 KV cache's decode step for Hopper (sm_90a): K7a and K7b.
//
// The cloud tail keeps its keys and values as int8 codes with one float32
// scale per (row, position, kv head) (models/layers/attention.py
// quantize_kv_row). These kernels replace no TPU kernel: the reference's
// int8 decode is plain jnp (quantize_kv_row, cache_update, scale_update,
// dequantize_kv, decode_attention), which dequantizes the whole cache every
// step. Here the cache is never widened in device memory.
//
// K7a  append — for every row whose live flag is on, the step's new key and
//      value rows (bf16 or f32, post-RoPE) quantized into the cache at slot
//      pos % S_c: amax in float32, scale = max(amax, 1e-8) * (1 / 127) as a
//      multiply, codes clip(rint(x / scale), -127, 127) with IEEE division
//      (__fdiv_rn, __fmul_rn: never contracted), so the codes and scales
//      are quantize_kv_row's bit for bit. One warp a (row, kv head, K or V);
//      rows whose flag is off keep their cache rows. Bound: the new rows
//      read and their codes and scales written, a few kB.
// K7b  attend — split-K decode attention ("flash decoding") over the codes:
//      grid (split, kv head x head group, row), kSplit positions a split.
//      A block loads the query heads of its kv group (at most kGroup of
//      them) once, streams the K codes of its positions (16-byte loads
//      where the head dim allows, kU loads a lane in flight) with their
//      scales, takes the scores and a softmax over its split in float32,
//      then streams the V codes. Codes are widened in registers: a byte
//      permute into a float's mantissa and one subtract, on the ALU pipe
//      (the conversion pipe runs at a quarter of the rate). A block whose
//      split starts at or past the row's valid length exits at once, so a
//      row reads only its own min(pos + 1, S_c) positions. A second, small
//      launch combines the splits' (max, sum, acc) in split order: no
//      atomics, so a row's result depends on its own length and S_c only,
//      whatever the other rows hold (the scheduler's batch invariance).
//      Bound: the valid positions' codes and scales, K and V, read once,
//      plus the queries and the output.
//
// Numerics of K7b against the plain route: scores and probabilities stay
// in float32 where the plain route rounds them to bf16, and a code's value
// is code * scale in float32 without the plain route's bf16 rounding of
// the dequantized value; the output is rounded once to the query's dtype.
// A row with pos + 1 <= 0 (no valid slot) averages every slot, as the plain
// route's softmax over an all-masked row does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"

namespace {

constexpr int kSplit = 256;       // positions a split (ops.py KV8_SPLIT)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHd = 256;       // widest head dim (ops.py KV8_MAX_HEAD_DIM)
constexpr int kGroup = 4;         // query heads a block at most
constexpr int kU = 4;             // positions a lane has in flight
constexpr float kInv127 = 1.0f / 127.0f;   // correctly rounded, as numpy's

// ---------------------------------------------------------------------------
// K7a: append
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long ring_slot(long long p, int s_c) {
  long long slot = p % s_c;
  return slot < 0 ? slot + s_c : slot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv8_append_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                  int8_t* __restrict__ kc, float* __restrict__ ks,
                  int8_t* __restrict__ vc, float* __restrict__ vs,
                  const long long* __restrict__ pos, long long pos_stride,
                  const unsigned char* __restrict__ live, int kv, int s_c,
                  int hd) {
  const int b = blockIdx.y;
  if (live != nullptr && !live[b]) return;
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;    // over 2 * kv
  if (w >= 2 * kv) return;
  const int lane = threadIdx.x & 31;
  const int h = w >> 1;
  const bool is_v = w & 1;
  const T* x = (is_v ? v_new : k_new) + (static_cast<long long>(b) * kv + h)
                                          * hd;
  const long long row =
      (static_cast<long long>(b) * s_c + ring_slot(pos[b * pos_stride], s_c))
      * kv + h;
  int8_t* codes = (is_v ? vc : kc) + row * hd;
  constexpr int kPer = kMaxHd / 32;
  float xs[kPer];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = lane + 32 * j;
    xs[j] = d < hd ? load_f32(x, d) : 0.0f;
    amax = fmaxf(amax, fabsf(xs[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = lane + 32 * j;
    if (d < hd) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(xs[j], scale)), -127.0f),
                            127.0f);
      codes[d] = static_cast<int8_t>(static_cast<int>(q));
    }
  }
  if (lane == 0) (is_v ? vs : ks)[row] = scale;
}

// ---------------------------------------------------------------------------
// K7b: attend (split kernel, then the combine)
// ---------------------------------------------------------------------------

// VEC int8 codes of one load, kept as 32-bit words.
template <int VEC>
struct Codes {
  int w[VEC >= 4 ? VEC / 4 : 1];
};

template <int VEC>
__device__ __forceinline__ Codes<VEC> load_codes(const int8_t* p) {
  Codes<VEC> c;
  if constexpr (VEC == 16) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    c.w[0] = t.x;
    c.w[1] = t.y;
    c.w[2] = t.z;
    c.w[3] = t.w;
  } else if constexpr (VEC == 8) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    c.w[0] = t.x;
    c.w[1] = t.y;
  } else if constexpr (VEC == 4) {
    c.w[0] = *reinterpret_cast<const int*>(p);
  } else if constexpr (VEC == 2) {
    c.w[0] = *reinterpret_cast<const short*>(p);
  } else {
    c.w[0] = *p;
  }
  return c;
}

// Code e of a load as a float, exactly: its byte, offset by 128, placed in
// the mantissa of 2^23, less 2^23 + 128.
template <int VEC>
__device__ __forceinline__ float code_at(const Codes<VEC>& c, int e) {
  const unsigned w = static_cast<unsigned>(c.w[e >> 2]) ^ 0x80808080u;
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | (e & 3))) -
         8388736.0f;
}

__device__ __forceinline__ int valid_len(const long long* pos,
                                         long long pos_stride, int b,
                                         int s_c) {
  const long long len = pos[b * pos_stride] + 1;
  return len <= 0 ? s_c : static_cast<int>(len < s_c ? len : s_c);
}

// K7b's arguments besides the queries and the output. part_acc: (B, H,
// n_split, hd) float32 partial sums; part_ml: (B, H, n_split, 2) (max, sum
// of exponentials); groups: head groups of at most GT query heads a kv
// head.
struct Attend {
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const long long* pos;
  long long pos_stride;
  int batch, heads, kv, s_c, hd, groups, n_split;
  float inv_sqrt;
  float* part_acc;
  float* part_ml;
};

// One block: split `blockIdx.x` of row `blockIdx.z`, kv head and head group
// `blockIdx.y`.
template <typename T, int VEC, int GT>
__global__ void __launch_bounds__(kThreads)
kv8_split_kernel(const T* __restrict__ q, const Attend a) {
  constexpr int NV = VEC >= 8 ? 1 : 8 / VEC;   // loads a lane a position
  const int8_t* __restrict__ kc = a.kc;
  const float* __restrict__ ks = a.ks;
  const int8_t* __restrict__ vc = a.vc;
  const float* __restrict__ vs = a.vs;
  const int heads = a.heads, kv = a.kv, s_c = a.s_c, hd = a.hd;
  __shared__ float sc[GT][kSplit];
  __shared__ float wacc[kWarps][GT * kMaxHd];
  __shared__ float red_m[GT], red_l[GT];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / a.groups;
  const int hg = blockIdx.y - kvh * a.groups;
  const int b = blockIdx.z;
  const bool uniform = a.pos[b * a.pos_stride] + 1 <= 0;
  const int n_all = valid_len(a.pos, a.pos_stride, b, s_c);
  const int start = split * kSplit;
  if (start >= n_all) return;
  const int n = min(kSplit, n_all - start);
  const int g = heads / kv;
  const int h0 = kvh * g + hg * GT;
  const int gt = min(GT, g - hg * GT);

  const int nvec = hd / VEC;
  int lpp = 1;                                  // lanes a position
  while (lpp < nvec && lpp < 32) lpp <<= 1;
  const int ppw = 32 / lpp;                     // positions a warp a step
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int grp = lane / lpp, lin = lane - grp * lpp;
  const int stride = kWarps * ppw;

  float qr[GT][NV][VEC];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lin + j * lpp;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[gi][j][e] = (gi < gt && v < nvec)
            ? load_f32(q, (static_cast<long long>(b) * heads + h0 + gi) * hd
                              + v * VEC + e)
            : 0.0f;
      }
    }
  }
  const long long row0 = static_cast<long long>(b) * s_c + start;

  // Scores of the split's positions, into sc.
  for (int it = warp * ppw; it < n; it += stride * kU) {
    Codes<VEC> raw[kU][NV];
    float kscale[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = it + u * stride + grp;
      if (i < n) {
        const long long prow = (row0 + i) * kv + kvh;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = lin + j * lpp;
          if (v < nvec) raw[u][j] = load_codes<VEC>(kc + prow * hd + v * VEC);
        }
        kscale[u] = ks[prow];
      }
    }
    float dot[kU][GT];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = it + u * stride + grp;
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) dot[u][gi] = 0.0f;
      if (i < n) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (lin + j * lpp < nvec) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float c = code_at<VEC>(raw[u][j], e);
#pragma unroll
              for (int gi = 0; gi < GT; ++gi) {
                dot[u][gi] = fmaf(qr[gi][j][e], c, dot[u][gi]);
              }
            }
          }
        }
      }
    }
    for (int off = lpp >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) {
          dot[u][gi] += __shfl_xor_sync(0xffffffffu, dot[u][gi], off);
        }
      }
    }
    if (lin == 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = it + u * stride + grp;
        if (i < n) {
#pragma unroll
          for (int gi = 0; gi < GT; ++gi) {
            sc[gi][i] = uniform ? 0.0f : dot[u][gi] * kscale[u] * a.inv_sqrt;
          }
        }
      }
    }
  }
  __syncthreads();

  // The split's max and sum of exponentials, one warp a query head; sc
  // becomes the exponentials.
  if (warp < gt) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[warp][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float l = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sc[warp][i] - m);
      sc[warp][i] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    if (lane == 0) {
      red_m[warp] = m;
      red_l[warp] = l;
    }
  }
  __syncthreads();

  // Exponential-weighted sums of the values.
  float acc[GT][NV][VEC];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][j][e] = 0.0f;
    }
  }
  for (int it = warp * ppw; it < n; it += stride * kU) {
    Codes<VEC> raw[kU][NV];
    float vscale[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = it + u * stride + grp;
      if (i < n) {
        const long long prow = (row0 + i) * kv + kvh;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = lin + j * lpp;
          if (v < nvec) raw[u][j] = load_codes<VEC>(vc + prow * hd + v * VEC);
        }
        vscale[u] = vs[prow];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = it + u * stride + grp;
      if (i < n) {
        float p[GT];
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) p[gi] = sc[gi][i] * vscale[u];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (lin + j * lpp < nvec) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float c = code_at<VEC>(raw[u][j], e);
#pragma unroll
              for (int gi = 0; gi < GT; ++gi) {
                acc[gi][j][e] = fmaf(p[gi], c, acc[gi][j][e]);
              }
            }
          }
        }
      }
    }
  }
  // Across a warp's position groups, then across the warps, in fixed order.
  for (int off = lpp; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[gi][j][e] += __shfl_xor_sync(0xffffffffu, acc[gi][j][e], off);
        }
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = lin + j * lpp;
        if (v < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            wacc[warp][gi * kMaxHd + v * VEC + e] = acc[gi][j][e];
          }
        }
      }
    }
  }
  __syncthreads();
  const long long head0 = static_cast<long long>(b) * heads + h0;
  for (int t = threadIdx.x; t < gt * hd; t += kThreads) {
    const int gi = t / hd, d = t - gi * hd;
    float s = wacc[0][gi * kMaxHd + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += wacc[w][gi * kMaxHd + d];
    a.part_acc[((head0 + gi) * a.n_split + split) * hd + d] = s;
  }
  if (threadIdx.x < gt) {
    float* ml = a.part_ml + ((head0 + threadIdx.x) * a.n_split + split) * 2;
    ml[0] = red_m[threadIdx.x];
    ml[1] = red_l[threadIdx.x];
  }
}

__device__ __forceinline__ void store_out(float* out, long long i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long i,
                                          float v) {
  out[i] = __float2bfloat16_rn(v);
}

// One block a (query head, row): the row's splits in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kv8_combine_kernel(const Attend a, T* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, hd = a.hd;
  const int ns =
      (valid_len(a.pos, a.pos_stride, b, a.s_c) + kSplit - 1) / kSplit;
  const long long head = static_cast<long long>(b) * a.heads + h;
  const float* ml = a.part_ml + head * a.n_split * 2;
  const float* acc = a.part_acc + head * a.n_split * hd;
  float m = -INFINITY;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.0f;
  for (int s = 0; s < ns; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float sum = 0.0f;
    for (int s = 0; s < ns; ++s) {
      sum += acc[static_cast<long long>(s) * hd + d] * expf(ml[2 * s] - m);
    }
    store_out(out, head * hd + d, sum / l);
  }
}

template <typename T, int VEC>
void launch_split(const T* q, const Attend& a, cudaStream_t stream) {
  const int g = a.heads / a.kv;
  Attend s = a;
  if (g <= 2) {
    s.groups = 1;
    const dim3 grid(a.n_split, a.kv, a.batch);
    if (g == 1) {
      kv8_split_kernel<T, VEC, 1><<<grid, kThreads, 0, stream>>>(q, s);
    } else {
      kv8_split_kernel<T, VEC, 2><<<grid, kThreads, 0, stream>>>(q, s);
    }
    return;
  }
  s.groups = (g + kGroup - 1) / kGroup;
  const dim3 grid(a.n_split, a.kv * s.groups, a.batch);
  kv8_split_kernel<T, VEC, kGroup><<<grid, kThreads, 0, stream>>>(q, s);
}

// The splits, then their combine.
template <typename T>
int launch_attend(const T* q, const Attend& a, int vec, T* out,
                  cudaStream_t stream) {
  switch (vec) {
    case 16: launch_split<T, 16>(q, a, stream); break;
    case 8: launch_split<T, 8>(q, a, stream); break;
    case 4: launch_split<T, 4>(q, a, stream); break;
    case 2: launch_split<T, 2>(q, a, stream); break;
    case 1: launch_split<T, 1>(q, a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  kv8_combine_kernel<T><<<dim3(a.heads, a.batch), kThreads, 0, stream>>>(
      a, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7a: k_new, v_new (B, 1, kv, hd) f32 (in_bf16 = 0) or bf16; caches kc, vc
// (B, S_c, kv, hd) int8 and ks, vs (B, S_c, kv) f32, written in place; pos
// (B,) int64 at element stride pos_stride; live (B,) bool or null (every
// row). One launch.
int jalad_kv8_append(const void* k_new, const void* v_new, int in_bf16,
                     void* kc, void* ks, void* vc, void* vs,
                     const long long* pos, long long pos_stride,
                     const unsigned char* live, int batch, int kv, int s_c,
                     int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((2 * kv + kWarps - 1) / kWarps, batch);
  int8_t* kcodes = static_cast<int8_t*>(kc);
  int8_t* vcodes = static_cast<int8_t*>(vc);
  float* kscales = static_cast<float*>(ks);
  float* vscales = static_cast<float*>(vs);
  if (in_bf16) {
    kv8_append_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), kcodes, kscales, vcodes,
        vscales, pos, pos_stride, live, kv, s_c, hd);
  } else {
    kv8_append_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        kcodes, kscales, vcodes, vscales, pos, pos_stride, live, kv, s_c, hd);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7b: q (B, 1, H, hd) f32 or bf16 -> out (B, 1, H, hd) of q's dtype, over
// the caches as K7a leaves them, each row's first min(pos + 1, S_c) slots
// (every slot where pos + 1 <= 0). vec: the codes a load (16, 8, 4, 2 or
// 1; it divides hd and both caches' addresses). part: float32 scratch of
// B * H * n_split * (hd + 2), n_split = ceil(S_c / kSplit). Two launches:
// the splits, then their combine.
int jalad_kv8_attend(const void* q, int in_bf16, const void* kc,
                     const void* ks, const void* vc, const void* vs,
                     const long long* pos, long long pos_stride, int batch,
                     int heads, int kv, int s_c, int hd, int vec,
                     float inv_sqrt, void* part, int n_split, void* out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const Attend a{static_cast<const int8_t*>(kc), static_cast<const float*>(ks),
                 static_cast<const int8_t*>(vc), static_cast<const float*>(vs),
                 pos, pos_stride, batch, heads, kv, s_c, hd, 1, n_split,
                 inv_sqrt, p,
                 p + static_cast<long long>(batch) * heads * n_split * hd};
  if (in_bf16) {
    return launch_attend(static_cast<const __nv_bfloat16*>(q), a, vec,
                         static_cast<__nv_bfloat16*>(out), s);
  }
  return launch_attend(static_cast<const float*>(q), a, vec,
                       static_cast<float*>(out), s);
}

}  // extern "C"
