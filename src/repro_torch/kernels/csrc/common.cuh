// Device code shared by the cache kernels: the key hash, the expert
// priorities and the warp argmin.  Header-only; every function is inline
// and internal to the translation unit that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// splitmix32, as repro_torch/core/hashing.py::splitmix32 computes it.
__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Expert codes, as kernels/sampled_eviction.py::KERNEL_EXPERTS orders them.
// The division rounds to nearest (no fast-math reciprocal).
__device__ __forceinline__ float priority(int code, float sz, float ins,
                                          float last, float fr, float clock) {
  switch (code) {
    case 0: return last;                                    // lru
    case 1: return fr;                                      // lfu
    case 2: return ins;                                     // fifo
    case 3: return -sz;                                     // size
    default:                                                // hyperbolic
      return __fdiv_rn(fr, fmaxf(__fsub_rn(clock, ins), 1.0f));
  }
}

// (v, i) := the warp's least v, the least i among equal v (jnp.argmin's
// first-index rule when i is the window position).
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, d);
    const int oi = __shfl_xor_sync(FULL, i, d);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

}  // namespace
