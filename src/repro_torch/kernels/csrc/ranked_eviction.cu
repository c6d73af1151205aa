// ranked_eviction: the sampled, expert-ranked eviction decision per op.
//
// Replaces the Pallas kernel repro/kernels/sampled_eviction.py::
// ranked_eviction (pallas_call at sampled_eviction.py:215).  Per op: a
// W-slot window from a random offset, indexed mod C (no wrap-padded copy
// of the table); the sample is its first K live slots (of tenant tfilt
// when tfilt >= 0); E expert priorities at the op's own timestamp; each
// expert's argmin is its candidate; the chosen expert's ranking is peeled
// up to K times while freed < quota, the value is finite and the op must
// evict.  An expert choice outside [0, E) takes no victim, as the
// reference backend decides (its gather of a missing expert reads NaN).
//
// Bound on the H100: bytes.  An op reads the size column until its K-th
// live slot (about 2K slots on a full table), four metadata words of each
// sampled slot and ~40 B of per-op inputs, and writes (K + E) int64
// outputs: ~0.5 KB an op, ~1 MB at B = 2048, ~0.3 us at 3.35 TB/s, far
// below one launch's latency.  Design: one warp per op.  Lanes read 32
// consecutive window slots at a time (coalesced); __ballot_sync + __popc
// rank the live ones, and the scan stops as soon as K are found (W > 32
// is a loop over 32-slot chunks, so W = 128 works).  The K sampled slots
// are then compacted onto lanes 0..K-1 through shared memory, so each
// argmin, and each of the K peel steps, is one warp reduction on
// (value, lane) with the lower lane -- the earlier window slot -- winning
// ties, as jnp.argmin does.  f32 arithmetic uses the explicit
// round-to-nearest intrinsics, so no FMA contraction changes a priority.
// Thread 0 of block 0 adds one to the launch counter, so a launch
// replayed from a CUDA graph is counted too.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32) ranked_eviction_kernel(
    const int64_t* __restrict__ size, const int64_t* __restrict__ ins_ts,
    const int64_t* __restrict__ last_ts, const int64_t* __restrict__ freq,
    const int64_t* __restrict__ tenant, int64_t C,
    const int64_t* __restrict__ offsets, const int64_t* __restrict__ e_choice,
    const bool* __restrict__ must_evict, const int64_t* __restrict__ quota,
    int quota_stride, const int64_t* __restrict__ tfilt,
    const int64_t* __restrict__ ts, const int* __restrict__ codes, int B,
    int W, int K, int E, int64_t* __restrict__ victims,
    int64_t* __restrict__ cand, unsigned long long* __restrict__ launches) {
  __shared__ int spos[WARPS][32];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;  // warp-uniform

  // 1. The sample: the first K eligible window positions.
  const int64_t off = offsets[b];
  const int64_t tf = tfilt ? tfilt[b] : -1;
  int cnt = 0;
  for (int base = 0; base < W && cnt < K; base += 32) {
    const int j = base + lane;
    bool elig = false;
    if (j < W) {
      const int64_t s = (off + j) % C;
      const int64_t sz = size[s];
      elig = sz > 0 && sz < 255 && (!tenant || tf < 0 || tenant[s] == tf);
    }
    const unsigned m = __ballot_sync(FULL, elig);
    const int r = cnt + __popc(m & ((1u << lane) - 1u));
    if (elig && r < K) spos[w][r] = j;
    cnt += __popc(m);
  }
  __syncwarp();
  cnt = min(cnt, K);

  // 2. Lane i < cnt holds sample i; every expert's argmin candidate.
  const bool have = lane < cnt;
  const int pos = have ? spos[w][lane] : 0;
  float sz = 0.f, ins = 0.f, last = 0.f, fr = 0.f;
  if (have) {
    const int64_t s = (off + pos) % C;
    sz = __uint2float_rn((unsigned)size[s]);
    ins = __uint2float_rn((unsigned)ins_ts[s]);
    last = __uint2float_rn((unsigned)last_ts[s]);
    fr = __uint2float_rn((unsigned)freq[s]);
  }
  const float clock = __uint2float_rn((unsigned)ts[b]);
  const int64_t choice = e_choice[b];
  float sel = CUDART_INF_F;
  for (int e = 0; e < E; ++e) {
    const float p =
        have ? priority(codes[e], sz, ins, last, fr, clock) : CUDART_INF_F;
    if (e == choice) sel = p;
    float v = p;
    int ix = have ? pos : 0x7fffffff;
    warp_argmin(v, ix);
    if (lane == 0) cand[(int64_t)b * E + e] = (off + (v < CUDART_INF_F ? ix : 0)) % C;
  }

  // 3. Peel the chosen expert's ranking until the quota is covered.
  const float q = (float)quota[(int64_t)quota_stride * b];
  const bool must = must_evict[b];
  float mine = sel;  // +inf off the sample, and for a choice outside [0, E)
  float freed = 0.f;
  for (int j = 0; j < K; ++j) {
    float v = mine;
    int ix = have ? lane : 0x7fffffff;
    warp_argmin(v, ix);
    const bool ok = freed < q && v < CUDART_INF_F && must;
    const int src = ix & 31;
    const float vsz = __shfl_sync(FULL, sz, src);
    const int vpos = __shfl_sync(FULL, pos, src);
    if (lane == 0) victims[(int64_t)b * K + j] = ok ? (off + vpos) % C : -1;
    if (ok) freed = __fadd_rn(freed, vsz);
    if (lane == ix) mine = CUDART_INF_F;
  }
}

}  // namespace

extern "C" int ranked_eviction_launch(
    const int64_t* size, const int64_t* ins_ts, const int64_t* last_ts,
    const int64_t* freq, const int64_t* tenant, int64_t C,
    const int64_t* offsets, const int64_t* e_choice, const bool* must_evict,
    const int64_t* quota, int quota_stride, const int64_t* tfilt,
    const int64_t* ts, const int* codes, int B, int W, int K, int E,
    int64_t* victims, int64_t* cand, unsigned long long* launches,
    void* stream) {
  if (B > 0) {
    ranked_eviction_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                             (cudaStream_t)stream>>>(
        size, ins_ts, last_ts, freq, tenant, C, offsets, e_choice, must_evict,
        quota, quota_stride, tfilt, ts, codes, B, W, K, E, victims, cand,
        launches);
  }
  return (int)cudaGetLastError();
}
