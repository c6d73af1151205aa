// Device code shared by the cache kernels: the key hash, the two bucket
// probes' tile of lanes a key and its bucket match, the expert
// priorities, the tile and warp argmins, and what the two eviction
// kernels share: the threefry draw, the one-round-trip sample gather and
// the interleaved argmins.  Header-only; every function is inline and
// internal to the translation unit that includes it.

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

// The bucket probes (access_probe, bucket_lookup) give each key a tile of
// T lanes of one warp, T the power of two >= assoc, at most 32.  Lane
// `sub` of the tile holds slot sub of each 32-slot chunk of the bucket,
// so a larger bucket is walked in chunks, in slot order.
__host__ __device__ inline int probe_tile(int assoc) {
  int t = 1;
  while (t < assoc && t < 32) t <<= 1;
  return t;
}

struct KeyTile {
  int sub;        // this lane's place in its tile
  int tbase;      // the tile's first lane in the warp
  unsigned mask;  // the tile's lanes
};

__device__ __forceinline__ KeyTile key_tile(int tile) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (tile - 1);
  const int tbase = lane - sub;
  return {sub, tbase, tile == 32 ? FULL : ((1u << tile) - 1u) << tbase};
}

// first := the bucket position of the first lane of the tile whose `hit`
// holds in chunk c, unless an earlier chunk set it (jnp.argmax's first
// index over the bucket).  Every lane of the warp takes part.
__device__ __forceinline__ void tile_first(int& first, bool hit, int c,
                                           const KeyTile& t) {
  const unsigned m = __ballot_sync(FULL, hit) & t.mask;
  if (first < 0 && m) first = (c << 5) + __ffs(m >> t.tbase) - 1;
}

// A live slot: 0 < size < 255 (0 is empty, 255 a history entry).
__device__ __forceinline__ bool live_slot(uint32_t sz) {
  return sz > 0u && sz < 255u;
}

// The bucket match: mi := the first live slot holding `key`, from this
// lane's slot of chunk c (size sz, key k; `in` when the lane has a slot).
__device__ __forceinline__ void tile_match(int& mi, bool in, uint32_t sz,
                                           uint32_t k, uint32_t key, int c,
                                           const KeyTile& t) {
  tile_first(mi, in && live_slot(sz) && k == key, c, t);
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

// (v, i) := the least v over each aligned tile of `width` lanes (a power
// of two, at most 32), the least i among equal v (jnp.argmin's first-index
// rule when i is the position).  Every lane of the warp takes part.
__device__ __forceinline__ void tile_argmin(float& v, int& i, int width) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, d);
    const int oi = __shfl_xor_sync(FULL, i, d);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// tile_argmin over the whole warp.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  tile_argmin(v, i, 32);
}

// tile_argmin of NE (value, index) pairs at once: each level's 2 * NE
// shuffles are independent, so they overlap instead of running as NE
// chained reductions.
template <int NE>
__device__ __forceinline__ void tile_argmin_n(float (&v)[NE], int (&i)[NE],
                                              int width) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    float ov[NE];
    int oi[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      ov[e] = __shfl_xor_sync(FULL, v[e], d);
      oi[e] = __shfl_xor_sync(FULL, i[e], d);
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (ov[e] < v[e] || (ov[e] == v[e] && oi[e] < i[e])) {
        v[e] = ov[e];
        i[e] = oi[e];
      }
    }
  }
}

// The eviction kernels take at most this many experts; their codes come
// by value, four bits each in one 64-bit kernel argument.
constexpr int MAX_EXPERTS = 8;

__device__ __forceinline__ int expert_code(int64_t codes, int e) {
  return (int)((codes >> (4 * e)) & 0xF);
}

// A sampled slot's metadata as f32, in the order of priority()'s
// arguments.
struct Md {
  float sz, ins, last, fr;
};

__device__ __forceinline__ float priority(int code, const Md& m,
                                          float clock) {
  return priority(code, m.sz, m.ins, m.last, m.fr, clock);
}

// Adds one 32-slot chunk of a window to a sample of its first K
// eligible slots, in window order: this lane's slot (window position j,
// metadata m) is sample cnt + its rank among the chunk's eligible lanes,
// stored if below K as pos[r] and md[f * ld + r] for field f of Md (in
// shared memory for K <= 32, a scratch row in device memory for wider
// samples).  Returns cnt plus the chunk's eligible count.  Every lane of
// the warp takes part; the caller __syncwarp()s before reading.
__device__ __forceinline__ int sample_chunk(bool elig, int j, const Md& m,
                                            int cnt, int K, int* pos,
                                            float* md, int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned mask = __ballot_sync(FULL, elig);
  const int r = cnt + __popc(mask & ((1u << lane) - 1u));
  if (elig && r < K) {
    pos[r] = j;
    md[r] = m.sz;
    md[ld + r] = m.ins;
    md[2 * ld + r] = m.last;
    md[3 * ld + r] = m.fr;
  }
  return cnt + __popc(mask);
}

// Four threefry rounds with rotations R0..R3.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R0) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R1) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R2) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds, on the counter pair (x0, x1) under the key
// (k0, k1), as repro_torch/core/prng.py::threefry2x32 computes it: the
// rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, the parity
// 0x1BD11BDA, and after each four rounds the key injection with + (i+1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

// One request's draw: prng.fold_in(key, d), then prng.uniform(., 2):
// u[i] from the bits y0 ^ y1 of threefry(step key, (0, i)), their 23 high
// bits OR'd into 1.0f, minus 1 (exact).
__device__ __forceinline__ void draw_uniform2(uint32_t k0, uint32_t k1,
                                              uint32_t d, float& u0,
                                              float& u1) {
  uint32_t s0 = 0u, s1 = d;
  threefry2x32(k0, k1, s0, s1);
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry2x32(s0, s1, a0, a1);
  threefry2x32(s0, s1, b0, b1);
  u0 = __fsub_rn(__uint_as_float(((a0 ^ a1) >> 9) | 0x3F800000u), 1.0f);
  u1 = __fsub_rn(__uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace
