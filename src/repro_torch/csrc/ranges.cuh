// Range reductions of the encode kernels (K1, K4, K6a) in the reference's
// order.
//
// XLA takes a minimum in the order in which -0.0 < +0.0, and a maximum in
// the same order: jnp.min of {+0.0, -0.0} is -0.0 and jnp.max is +0.0,
// whichever comes first. A range header must equal the reference's bit for
// bit, and blocks on a GPU fold in no fixed order, so every fold here runs
// on the order key of each float, an int whose signed order is that total
// order (-inf < ... < -0.0 < +0.0 < ... < +inf), never on fminf / fmaxf
// (whose treatment of signed zeros is not relied on). A key min / max is
// one integer instruction, and a warp folds its keys with one redux.sync
// each. A NaN is skipped, as fminf / fmaxf skip it: a range over NaN only
// stays (+inf, -inf).
#pragma once

#include <cuda_runtime.h>

// The key of f, and back: flip the magnitude bits of a negative float.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// order_key(+inf) and order_key(-inf): the empty range.
constexpr int kKeyPosInf = 0x7f800000;
constexpr int kKeyNegInf = static_cast<int>(0xff800000u ^ 0x7fffffffu);

// A running (min, max) as keys.
struct KeyRange {
  int lo = kKeyPosInf;
  int hi = kKeyNegInf;

  __device__ __forceinline__ void add(float f) {
    const int k = order_key(f);
    if (!isnan(f)) {
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }

  __device__ __forceinline__ void add(int klo, int khi) {
    lo = min(lo, klo);
    hi = max(hi, khi);
  }

  __device__ __forceinline__ float min_value() const { return key_float(lo); }
  __device__ __forceinline__ float max_value() const { return key_float(hi); }
};

// The range of a full warp; every lane returns it.
__device__ __forceinline__ void warp_range(KeyRange& r) {
  r.lo = __reduce_min_sync(0xffffffffu, r.lo);
  r.hi = __reduce_max_sync(0xffffffffu, r.hi);
}

// The range of the block (blockDim.x a multiple of 32, at most 1024); every
// thread returns it. Ends with a __syncthreads, so the block may call it
// again.
__device__ __forceinline__ void block_range(KeyRange& r) {
  __shared__ int s_lo[32];
  __shared__ int s_hi[32];
  __shared__ int s_out[2];
  warp_range(r);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = r.lo;
    s_hi[warp] = r.hi;
  }
  __syncthreads();
  if (warp == 0) {
    KeyRange w;
    if (lane < static_cast<int>(blockDim.x >> 5)) w.add(s_lo[lane], s_hi[lane]);
    warp_range(w);
    if (lane == 0) {
      s_out[0] = w.lo;
      s_out[1] = w.hi;
    }
  }
  __syncthreads();
  r.lo = s_out[0];
  r.hi = s_out[1];
  __syncthreads();
}
