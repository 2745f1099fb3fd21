// Element loads and code rounding shared by the per-tensor encode kernels:
// K1 (quantize.cu), K6a and K6b (threelaunch.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ranges.cuh"

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// One 16-byte load of the input: its kVec elements as floats.
template <typename T>
struct In;

template <>
struct In<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& w, float (&v)[kVec]) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
};

template <>
struct In<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& w, float (&v)[kVec]) {
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  }
};

// The elements of one 16-byte load folded into r.
template <typename T>
__device__ __forceinline__ void fold_vec(const uint4& w, KeyRange& r) {
  float v[In<T>::kVec];
  In<T>::unpack(w, v);
#pragma unroll
  for (int i = 0; i < In<T>::kVec; ++i) r.add(v[i]);
}

// clip(rint((v - mn) * scale), 0, levels). The clip comes first (the same
// code for every input, NaN included, which maps to 0); then adding 1.5 *
// 2^23 rounds half to even, exactly below 2^22, and leaves the integer in
// the low bits. Float subtract, multiply and add run at the full rate,
// where rintf and a float-to-int conversion would take the SM's 16-a-clock
// conversion pipe twice an element.
__device__ __forceinline__ unsigned quant_code(float v, float mn, float scale,
                                               float levels) {
  const float y =
      fminf(fmaxf(__fmul_rn(__fsub_rn(v, mn), scale), 0.0f), levels);
  return __float_as_uint(__fadd_rn(y, 12582912.0f)) - 0x4B400000u;
}
