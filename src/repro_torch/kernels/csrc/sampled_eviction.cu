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
// below one launch's latency.  Design: ranked_eviction's sample code
// (csrc/common.cuh): one warp per op; lanes load 32 consecutive window
// slots' four f32 words at once (one round trip a chunk, W > 32 loops),
// __ballot_sync + __popc rank the live ones, and the gather stops once K
// are found.  For K <= 32 the sample is compacted through shared memory
// onto lanes 0..K-1, and the E argmins reduce together on (value,
// position) over the next power of two >= K lanes, the earlier window
// position winning ties as jnp.argmin does.  A sample of K > 32 is kept
// in a per-op scratch row (the wrapper's, in device memory: positions and
// the four words), ceil(K / 32) entries a lane, and each argmin is a min
// over the lane's entries, then the same reduction over the warp.  The
// expert codes are kernel arguments (four bits each), not a device array.
// The hyperbolic priority divides with round-to-nearest, so it rounds as
// the plain version's f32 division does.  The clock is read through a
// pointer when the caller holds it on the card (no host sync), else
// passed by value.  Thread 0 of block 0 adds one to the launch counter,
// so a launch replayed from a CUDA graph is counted too.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;

struct SampleArgs {
  const float* size;  // the padded f32 columns [N]
  const float* ins_ts;
  const float* last_ts;
  const float* freq;
  int64_t N;
  const int64_t* offsets;
  const int64_t* e_choice;
  const float* clock_ptr;  // or null: clock_val
  float clock_val;
  int64_t codes;  // expert e's code in bits [4e, 4e + 4)
  int B, W, K, E;
  int64_t* victim;  // [B]
  int64_t* cand;    // [B, E]
  int* wpos;        // K > 32: [B, K] sample positions
  float* wmd;       // K > 32: [B, 4, K] sample metadata
  unsigned long long* launches;
};

template <bool WIDE, int NE>
__global__ void __launch_bounds__(WARPS * 32)
    sampled_eviction_kernel(const __grid_constant__ SampleArgs a) {
  __shared__ int spos[WARPS][32];
  __shared__ float smd[WARPS][4 * 32];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.launches, 1ull);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= a.B) return;  // warp-uniform
  const int K = a.K, E = a.E;

  // 1. The op's inputs, then the sample: the first K live window
  //    positions, each slot's four words loaded in one round trip.
  const int64_t off = a.offsets[b];
  const int64_t c = a.e_choice[b];
  const int choice = c >= 0 && c < E ? (int)c : -1;
  const float clock = a.clock_ptr ? a.clock_ptr[0] : a.clock_val;
  int* pos = WIDE ? a.wpos + (int64_t)b * K : spos[w];
  float* md = WIDE ? a.wmd + (int64_t)b * 4 * K : smd[w];
  const int ld = WIDE ? K : 32;
  int cnt = 0;
  for (int c0 = 0; c0 < a.W && cnt < K; c0 += 32) {
    const int j = c0 + lane;
    const int64_t p = off + j;
    Md m{0.f, 0.f, 0.f, 0.f};
    if (j < a.W && p >= 0 && p < a.N)
      m = Md{a.size[p], a.ins_ts[p], a.last_ts[p], a.freq[p]};
    const bool live = m.sz > 0.0f && m.sz < 255.0f;
    cnt = sample_chunk(live, j, m, cnt, K, pos, md, ld);
  }
  __syncwarp();
  cnt = min(cnt, K);

  // 2. Every expert's argmin candidate, reduced together: for K <= 32
  //    lane i < cnt holds sample i; a wider sample is walked from the
  //    scratch row, sample i on lane i mod 32 (in window order, so a lane
  //    keeps its earlier entry on a tie).
  float v[NE];
  int ix[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    v[e] = CUDART_INF_F;
    ix[e] = 0x7fffffff;
  }
  int width = 32;
  if constexpr (WIDE) {
    for (int i = lane; i < cnt; i += 32) {
      const Md m{md[i], md[K + i], md[2 * K + i], md[3 * K + i]};
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (e < E) {
          const float pr = priority(expert_code(a.codes, e), m, clock);
          if (pr < v[e]) {
            v[e] = pr;
            ix[e] = pos[i];
          }
        }
      }
    }
  } else {
    if (lane < cnt) {
      const Md m{smd[w][lane], smd[w][32 + lane], smd[w][64 + lane],
                 smd[w][96 + lane]};
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (e < E) {
          v[e] = priority(expert_code(a.codes, e), m, clock);
          ix[e] = spos[w][lane];
        }
      }
    }
    width = 1;
    while (width < K) width <<= 1;
  }
  tile_argmin_n<NE>(v, ix, width);
  if (lane == 0) {
    int64_t chosen = -1;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (e < E) {
        // An all-infinite sample ranks its first window position, as
        // argmin over the inf-masked window does.
        const int64_t cd =
            cnt > 0 ? off + (v[e] < CUDART_INF_F ? ix[e] : 0) : -1;
        a.cand[(int64_t)b * E + e] = cd;
        if (e == choice) chosen = cd;
      }
    }
    a.victim[b] = chosen;
  }
}

template <bool WIDE, int NE>
int go(const SampleArgs& a, cudaStream_t stream) {
  const dim3 grid((a.B + WARPS - 1) / WARPS), block(WARPS * 32);
  sampled_eviction_kernel<WIDE, NE><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sampled_eviction_launch(
    const float* size, const float* ins_ts, const float* last_ts,
    const float* freq, int64_t N, const int64_t* offsets,
    const int64_t* e_choice, const float* clock_ptr, float clock_val,
    int64_t codes, int B, int W, int K, int E, int64_t* victim,
    int64_t* cand, int* wpos, float* wmd, unsigned long long* launches,
    void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (E < 1 || E > MAX_EXPERTS || K < 1) return (int)cudaErrorInvalidValue;
  const SampleArgs a{size, ins_ts, last_ts, freq, N, offsets, e_choice,
                     clock_ptr, clock_val, codes, B, W, K, E, victim, cand,
                     wpos, wmd, launches};
  const cudaStream_t s = (cudaStream_t)stream;
  if (K > 32) {
    if (!wpos || !wmd) return (int)cudaErrorInvalidValue;
    return go<true, MAX_EXPERTS>(a, s);
  }
  if (E == 1) return go<false, 1>(a, s);
  if (E == 2) return go<false, 2>(a, s);
  if (E <= 5) return go<false, 5>(a, s);
  return go<false, MAX_EXPERTS>(a, s);
}
