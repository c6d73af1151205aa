// sampled_eviction: the single-victim sampled eviction decision per op at
// one scalar clock.
//
// Replaces the Pallas kernel repro/kernels/sampled_eviction.py::
// sampled_eviction (pallas_call at sampled_eviction.py:251).  Per op: the
// W-slot window [off, off + W) of f32 columns that the caller padded at
// the tail with empty slots (never indexed mod C; a position outside the
// columns reads as an empty slot); the sample is its first K live slots
// (0 < size < 255); E expert priorities at the one clock; each expert's
// argmin over the sample is its candidate, -1 for every expert when the
// sample is empty; the victim is the candidate of the op's chosen expert
// (-1 for a choice outside [0, E)).  Returned slots are window positions
// off + j, not taken mod C.  Unlike ranked_eviction there is no quota,
// no must-evict flag and no tenant filter.
//
// Bound on the H100: bytes.  An op reads the size column until its K-th
// live slot (about 2.5K slots at 40% occupancy), three more columns at
// each sampled slot and 16 B of per-op inputs, and writes (1 + E) int64
// outputs: ~0.2 KB an op, ~0.3 MB at B = 2048, ~0.1 us at 3.35 TB/s, far
// below one launch's latency.  Design, as ranked_eviction's: one warp per
// op; lanes read 32 consecutive window slots at a time (coalesced),
// __ballot_sync + __popc rank the live ones, and the scan stops once K
// are found (W > 32 is a loop over 32-slot chunks).  The K sampled
// positions are compacted onto lanes 0..K-1 through shared memory, so
// each expert's argmin is one warp reduction on (value, position), the
// earlier window position winning ties as jnp.argmin does.  The
// hyperbolic priority divides with round-to-nearest, so it rounds as the
// plain version's f32 division does.  The clock is read through a
// pointer when the caller holds it on the card (no host sync), else
// passed by value.  Thread 0 of block 0 adds one to the launch counter,
// so a launch replayed from a CUDA graph is counted too.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32) sampled_eviction_kernel(
    const float* __restrict__ size, const float* __restrict__ ins_ts,
    const float* __restrict__ last_ts, const float* __restrict__ freq,
    int64_t N, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ e_choice, const float* __restrict__ clock_ptr,
    float clock_val, const int* __restrict__ codes, int B, int W, int K,
    int E, int64_t* __restrict__ victim, int64_t* __restrict__ cand,
    unsigned long long* __restrict__ launches) {
  __shared__ int spos[WARPS][32];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;  // warp-uniform

  // 1. The sample: the first K live window positions.
  const int64_t off = offsets[b];
  int cnt = 0;
  for (int base = 0; base < W && cnt < K; base += 32) {
    const int j = base + lane;
    const int64_t p = off + j;
    bool live = false;
    if (j < W && p >= 0 && p < N) {
      const float sz = size[p];
      live = sz > 0.0f && sz < 255.0f;
    }
    const unsigned m = __ballot_sync(FULL, live);
    const int r = cnt + __popc(m & ((1u << lane) - 1u));
    if (live && r < K) spos[w][r] = j;
    cnt += __popc(m);
  }
  __syncwarp();
  cnt = min(cnt, K);

  // 2. Lane i < cnt holds sample i; every expert's argmin candidate.
  const bool have = lane < cnt;
  const int pos = have ? spos[w][lane] : 0;
  float sz = 0.f, ins = 0.f, last = 0.f, fr = 0.f;
  if (have) {
    sz = size[off + pos];
    ins = ins_ts[off + pos];
    last = last_ts[off + pos];
    fr = freq[off + pos];
  }
  const float clock = clock_ptr ? clock_ptr[0] : clock_val;
  const int64_t choice = e_choice[b];
  int64_t chosen = -1;
  for (int e = 0; e < E; ++e) {
    float v =
        have ? priority(codes[e], sz, ins, last, fr, clock) : CUDART_INF_F;
    int ix = have ? pos : 0x7fffffff;
    warp_argmin(v, ix);
    // An all-infinite sample ranks its first window position, as
    // argmin over the inf-masked window does.
    const int64_t c = cnt > 0 ? off + (v < CUDART_INF_F ? ix : 0) : -1;
    if (lane == 0) cand[(int64_t)b * E + e] = c;
    if (e == choice) chosen = c;
  }
  if (lane == 0) victim[b] = chosen;
}

}  // namespace

extern "C" int sampled_eviction_launch(
    const float* size, const float* ins_ts, const float* last_ts,
    const float* freq, int64_t N, const int64_t* offsets,
    const int64_t* e_choice, const float* clock_ptr, float clock_val,
    const int* codes, int B, int W, int K, int E, int64_t* victim,
    int64_t* cand, unsigned long long* launches, void* stream) {
  if (B > 0) {
    sampled_eviction_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                              (cudaStream_t)stream>>>(
        size, ins_ts, last_ts, freq, N, offsets, e_choice, clock_ptr,
        clock_val, codes, B, W, K, E, victim, cand, launches);
  }
  return (int)cudaGetLastError();
}
