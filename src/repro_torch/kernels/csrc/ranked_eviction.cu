// ranked_eviction: the sampled, expert-ranked eviction decision per op,
// in two forms: given each op's window offset and expert choice
// (ranked_eviction_launch), or drawing them itself
// (ranked_eviction_draw_launch, the cache step's form).
//
// Replaces the Pallas kernel repro/kernels/sampled_eviction.py::
// ranked_eviction (pallas_call at sampled_eviction.py:215).  Per op: a
// W-slot window from an offset, indexed mod C (no wrap-padded copy of the
// table); the sample is its first K live slots (of tenant tfilt when
// tfilt >= 0); E expert priorities at the op's own timestamp; each
// expert's argmin is its candidate; the chosen expert's ranking is taken
// lowest first while the blocks freed before a victim fall short of the
// quota, its priority is finite and the op must evict, at most K victims.
// An expert choice outside [0, E) takes no victim, as the reference
// backend decides (its gather of a missing expert reads NaN).
//
// The draw form is the cache step's one threefry draw a request
// (core/cache.py; the JAX package's cache.py:199 and :358) in registers:
// the key rng[b % lanes], fold_in of the op's timestamp, two uniforms;
// the offset is min(trunc(u1 * f32(C)), C - 1) and the choice the count
// of the lane's cdf entries below u0 (an f32 cdf that rounds below u
// everywhere gives E: no victim).  With per-op tenant ids (op_tenant,
// multi-tenant caches) the cdf holds a row per (lane, tenant), [lanes, T,
// E], and op b reads row (b % lanes, op_tenant[b]) (the JAX package's
// cache.py:382; ids clamped into [0, T), as the step clamps them); the
// tenant filter tfilt of the given form applies to both forms.  The draw
// form also writes the choice and each victim entry's expert bitmap,
// sum_e (cand[e] == victim) << e | 1 << choice (the JAX package's
// cache.py:604-610), -1 entries included.
//
// Bound on the H100: bytes.  An op reads its window's size column until
// the K-th live slot and three more words of each sampled slot (~2K
// slots on a full table), ~40 B of per-op inputs (the draw form: the
// lane's 16-B key and 4E-B cdf row, read by every op of the lane; with
// a tenant filter, each scanned slot's tenant word too, and the scan
// runs until K of the op's tenant's slots), and
// writes (K + E) int64 outputs (the draw form 2K + E + 1): ~0.5 KB an
// op, ~1 MB at B = 2048, ~0.3 us at 3.35 TB/s, far below one launch's
// latency.  So the design counts dependent steps, not bytes.  One warp
// per op.  (1) Every input of the op is loaded at once; the draw's three
// threefry blocks (~200 integer operations) run on every lane, so no
// shuffle carries them.  (2) One round trip gathers the window: lane j
// loads slot j's size, insert_ts, last_ts and freq (and tenant) together,
// 32 slots a chunk (W > 32 loops), stopping once K are found; ballot and
// popc rank the eligible ones, and the sample is compacted through shared
// memory onto lanes 0..K-1 in window order.  (3) The expert codes are
// kernel arguments (four bits each), so no load sits in the expert loop
// behind a store; the E argmins reduce together over the next power of
// two >= K lanes (first index on ties, as jnp.argmin).  (4) No serial
// peel: lane i ranks its sample among the others by K independent
// shuffles (value, then window position) and sums the sizes ranked below
// it; it is a victim iff that sum < quota, its value is finite and the op
// must evict.  That is the peel's result: the peel's freed sum before a
// victim is the sum of every size ranked below it while it takes, and
// once it stops (sum >= quota, an infinite value, or no must) every
// later rank fails the same test, since sizes are >= 0 and values rise.
// Sizes are integers below 255 and at most K <= 32 of them are added,
// so the f32 sums are exact in any order.  A sample of K > 32 does not
// fit the lanes: it is kept in a per-op scratch row (the wrapper's, in
// device memory; the warp's own L1 lines), ceil(K / 32) entries a lane,
// gathered in the same one round trip a chunk, and its victims are
// peeled K times as before (the warp reduction on (value, sample index)).
// f32 arithmetic uses the explicit round-to-nearest intrinsics, so no
// FMA contraction changes a priority or the offset.  Thread 0 of block 0
// adds one to the launch counter, so a launch replayed from a CUDA graph
// is counted too.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;

struct EvictArgs {
  // The table's u32 columns [C] as int64, and the tenant column or null.
  const int64_t* size;
  const int64_t* ins_ts;
  const int64_t* last_ts;
  const int64_t* freq;
  const int64_t* tenant;
  int64_t C;
  // The given form: each op's window offset and expert choice.
  const int64_t* offsets;
  const int64_t* e_choice;
  // The draw form: the lanes' keys [lanes, 2] (u32 as int64) and expert
  // cdf rows [lanes, E], or [lanes, T, E] with each op's tenant id.
  const int64_t* rng;
  const float* cdf;
  int lanes;
  const int64_t* op_tenant;  // [B] or null
  int T;
  const bool* must_evict;
  const int64_t* quota;
  int quota_stride;  // 1: per op; 0: one quota for all
  const int64_t* tfilt;
  const int64_t* ts;
  int64_t codes;  // expert e's code in bits [4e, 4e + 4)
  int B, W, K, E;
  int64_t* victims;  // [B, K]
  int64_t* cand;     // [B, E]
  int64_t* e_out;    // [B] (draw form)
  int64_t* bmap;     // [B, K] (draw form)
  int* wpos;         // K > 32: [B, K] sample positions
  float* wmd;        // K > 32: [B, 5, K] sample metadata and priority
  unsigned long long* launches;
};

// (off + j) mod C for 0 <= off < C and 0 <= j <= C.
__device__ __forceinline__ int64_t wrap(int64_t s, int64_t C) {
  return s >= C ? s - C : s;
}

template <bool DRAW, bool WIDE, int NE>
__global__ void __launch_bounds__(WARPS * 32)
    ranked_eviction_kernel(const __grid_constant__ EvictArgs a) {
  __shared__ int spos[WARPS][32];
  __shared__ float smd[WARPS][4 * 32];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.launches, 1ull);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= a.B) return;  // warp-uniform
  const int K = a.K, E = a.E;
  const int64_t C = a.C;

  // 1. The op's inputs, loaded together; the draw in registers.
  const int64_t tsb = a.ts[b];
  const bool must = a.must_evict[b];
  const float q = (float)a.quota[(int64_t)a.quota_stride * b];
  const int64_t tf = a.tfilt ? a.tfilt[b] : -1;
  int64_t base;  // the window's first slot, in [0, C)
  int choice;
  if constexpr (DRAW) {
    const int ln = b % a.lanes;
    const uint32_t k0 = (uint32_t)a.rng[2 * ln];
    const uint32_t k1 = (uint32_t)a.rng[2 * ln + 1];
    int64_t row = ln;
    if (a.op_tenant) {
      const int64_t t = a.op_tenant[b];
      row = (int64_t)ln * a.T + (t < 0 ? 0 : t >= a.T ? a.T - 1 : t);
    }
    float cdf[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e)
      cdf[e] = e < E ? a.cdf[row * E + e] : CUDART_INF_F;
    float u0, u1;
    draw_uniform2(k0, k1, (uint32_t)tsb, u0, u1);
    const int64_t at = (int64_t)__fmul_rn(u1, (float)C);  // truncates
    base = at < C ? at : C - 1;
    choice = 0;
#pragma unroll
    for (int e = 0; e < NE; ++e) choice += cdf[e] < u0;
  } else {
    base = a.offsets[b] % C;
    if (base < 0) base += C;  // the floor mod of torch.remainder
    const int64_t c = a.e_choice[b];
    choice = c >= 0 && c < E ? (int)c : -1;
  }
  const float clock = __uint2float_rn((unsigned)tsb);

  // 2. The sample: the first K eligible window slots, each slot's four
  //    words loaded in one round trip.
  int* pos = WIDE ? a.wpos + (int64_t)b * K : spos[w];
  float* md = WIDE ? a.wmd + (int64_t)b * 5 * K : smd[w];
  const int ld = WIDE ? K : 32;
  int cnt = 0;
  for (int c0 = 0; c0 < a.W && cnt < K; c0 += 32) {
    const int j = c0 + lane;
    bool elig = false;
    Md m{0.f, 0.f, 0.f, 0.f};
    if (j < a.W) {
      const int64_t s = wrap(base + j, C);
      const int64_t sz = a.size[s];
      const int64_t ins = a.ins_ts[s];
      const int64_t last = a.last_ts[s];
      const int64_t fr = a.freq[s];
      const bool ours = !a.tenant || tf < 0 || a.tenant[s] == tf;
      elig = sz > 0 && sz < 255 && ours;
      m = Md{__uint2float_rn((unsigned)sz), __uint2float_rn((unsigned)ins),
             __uint2float_rn((unsigned)last), __uint2float_rn((unsigned)fr)};
    }
    cnt = sample_chunk(elig, j, m, cnt, K, pos, md, ld);
  }
  __syncwarp();
  cnt = min(cnt, K);

  float v[NE];
  int ix[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    v[e] = CUDART_INF_F;
    ix[e] = 0x7fffffff;
  }

  if constexpr (!WIDE) {
    // 3. Lane i < cnt holds sample i; every expert's argmin at once.
    const bool have = lane < cnt;
    const int p = have ? spos[w][lane] : 0;
    const Md m = have ? Md{smd[w][lane], smd[w][32 + lane],
                           smd[w][64 + lane], smd[w][96 + lane]}
                      : Md{0.f, 0.f, 0.f, 0.f};
    float mine = CUDART_INF_F;  // the chosen expert's priority
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (have && e < E) {
        v[e] = priority(expert_code(a.codes, e), m, clock);
        ix[e] = p;
        if (e == choice) mine = v[e];
      }
    }
    int width = 1;
    while (width < K) width <<= 1;
    tile_argmin_n<NE>(v, ix, width);
    int64_t cd[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e)
      cd[e] = wrap(base + (v[e] < CUDART_INF_F ? ix[e] : 0), C);
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (e < E) a.cand[(int64_t)b * E + e] = cd[e];
      if constexpr (DRAW) a.e_out[b] = choice;
    }

    // 4. The ranking, with no serial peel: sample i's rank and the sizes
    //    ranked below it, from the other samples' independent shuffles.
    const float msz = have ? m.sz : 0.f;
    int rank = 0;
    float before = 0.f;
    for (int i = 0; i < K; ++i) {
      const float vi = __shfl_sync(FULL, mine, i);
      const float si = __shfl_sync(FULL, msz, i);
      const bool lower = vi < mine || (vi == mine && i < lane);
      rank += lower;
      before = __fadd_rn(before, lower ? si : 0.f);
    }
    if (lane < K) {
      const bool take = have && mine < CUDART_INF_F && must && before < q;
      const int64_t at = (int64_t)b * K + (have ? rank : lane);
      const int64_t vic = take ? wrap(base + p, C) : -1;
      a.victims[at] = vic;
      if constexpr (DRAW) {
        int64_t bm = 1ll << choice;
#pragma unroll
        for (int e = 0; e < NE; ++e)
          if (e < E && cd[e] == vic) bm |= 1ll << e;
        a.bmap[at] = bm;
      }
    }
  } else {
    // 3. Sample i on lane i mod 32: its chosen priority into the scratch
    //    row; every expert's argmin (entries in window order, so a lane
    //    keeps its earlier entry on a tie).
    for (int i = lane; i < cnt; i += 32) {
      const Md m{md[i], md[K + i], md[2 * K + i], md[3 * K + i]};
      float sel = CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (e < E) {
          const float pr = priority(expert_code(a.codes, e), m, clock);
          if (pr < v[e]) {
            v[e] = pr;
            ix[e] = pos[i];
          }
          if (e == choice) sel = pr;
        }
      }
      md[4 * K + i] = sel;
    }
    tile_argmin_n<NE>(v, ix, 32);
    int64_t cd[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e)
      cd[e] = wrap(base + (v[e] < CUDART_INF_F ? ix[e] : 0), C);
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (e < E) a.cand[(int64_t)b * E + e] = cd[e];
      if constexpr (DRAW) a.e_out[b] = choice;
    }
    __syncwarp();

    // 4. Peel the chosen expert's ranking until the quota is covered.
    float freed = 0.f;
    for (int j = 0; j < K; ++j) {
      float vv = CUDART_INF_F;
      int ii = 0x7fffffff;
      for (int i = lane; i < cnt; i += 32) {
        if (md[4 * K + i] < vv) {
          vv = md[4 * K + i];
          ii = i;
        }
      }
      warp_argmin(vv, ii);
      const bool ok = freed < q && vv < CUDART_INF_F && must;
      if (lane == 0) {
        const int64_t vic = ok ? wrap(base + pos[ii], C) : -1;
        a.victims[(int64_t)b * K + j] = vic;
        if constexpr (DRAW) {
          int64_t bm = 1ll << choice;
#pragma unroll
          for (int e = 0; e < NE; ++e)
            if (e < E && cd[e] == vic) bm |= 1ll << e;
          a.bmap[(int64_t)b * K + j] = bm;
        }
      }
      if (ok) freed = __fadd_rn(freed, md[ii]);
      __syncwarp();
      if (ok && lane == (ii & 31)) md[4 * K + ii] = CUDART_INF_F;
      __syncwarp();
    }
  }
}

template <bool DRAW, bool WIDE, int NE>
int go(const EvictArgs& a, cudaStream_t stream) {
  const dim3 grid((a.B + WARPS - 1) / WARPS), block(WARPS * 32);
  ranked_eviction_kernel<DRAW, WIDE, NE><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The narrow kernel unrolls its expert loops to E rounded up to 1, 2, 5
// or 8; the wide one to 8.
template <bool DRAW>
int dispatch(const EvictArgs& a, cudaStream_t stream) {
  if (a.B <= 0) return (int)cudaGetLastError();
  if (a.E < 1 || a.E > MAX_EXPERTS || a.K < 1 ||
      (DRAW && (a.lanes < 1 || (a.op_tenant && a.T < 1))))
    return (int)cudaErrorInvalidValue;
  if (a.K > 32) {
    if (!a.wpos || !a.wmd) return (int)cudaErrorInvalidValue;
    return go<DRAW, true, MAX_EXPERTS>(a, stream);
  }
  if (a.E == 1) return go<DRAW, false, 1>(a, stream);
  if (a.E == 2) return go<DRAW, false, 2>(a, stream);
  if (a.E <= 5) return go<DRAW, false, 5>(a, stream);
  return go<DRAW, false, MAX_EXPERTS>(a, stream);
}

}  // namespace

extern "C" int ranked_eviction_launch(
    const int64_t* size, const int64_t* ins_ts, const int64_t* last_ts,
    const int64_t* freq, const int64_t* tenant, int64_t C,
    const int64_t* offsets, const int64_t* e_choice, const bool* must_evict,
    const int64_t* quota, int quota_stride, const int64_t* tfilt,
    const int64_t* ts, int64_t codes, int B, int W, int K, int E,
    int64_t* victims, int64_t* cand, int* wpos, float* wmd,
    unsigned long long* launches, void* stream) {
  EvictArgs a{};
  a.size = size;
  a.ins_ts = ins_ts;
  a.last_ts = last_ts;
  a.freq = freq;
  a.tenant = tenant;
  a.C = C;
  a.offsets = offsets;
  a.e_choice = e_choice;
  a.must_evict = must_evict;
  a.quota = quota;
  a.quota_stride = quota_stride;
  a.tfilt = tfilt;
  a.ts = ts;
  a.codes = codes;
  a.B = B;
  a.W = W;
  a.K = K;
  a.E = E;
  a.victims = victims;
  a.cand = cand;
  a.wpos = wpos;
  a.wmd = wmd;
  a.launches = launches;
  return dispatch<false>(a, (cudaStream_t)stream);
}

// tenant and tfilt (the sample filter) may be null, and op_tenant (a
// cdf row per (lane, tenant), T tenants) may be null: the untenanted form.
extern "C" int ranked_eviction_draw_launch(
    const int64_t* size, const int64_t* ins_ts, const int64_t* last_ts,
    const int64_t* freq, const int64_t* tenant, int64_t C, const int64_t* rng,
    int lanes, const float* cdf, const int64_t* op_tenant, int T,
    const bool* must_evict, const int64_t* quota, int quota_stride,
    const int64_t* tfilt, const int64_t* ts, int64_t codes, int B, int W,
    int K, int E, int64_t* victims, int64_t* cand, int64_t* e_out,
    int64_t* bmap, int* wpos, float* wmd, unsigned long long* launches,
    void* stream) {
  EvictArgs a{};
  a.size = size;
  a.ins_ts = ins_ts;
  a.last_ts = last_ts;
  a.freq = freq;
  a.tenant = tenant;
  a.C = C;
  a.rng = rng;
  a.lanes = lanes;
  a.cdf = cdf;
  a.op_tenant = op_tenant;
  a.T = T;
  a.must_evict = must_evict;
  a.quota = quota;
  a.quota_stride = quota_stride;
  a.tfilt = tfilt;
  a.ts = ts;
  a.codes = codes;
  a.B = B;
  a.W = W;
  a.K = K;
  a.E = E;
  a.victims = victims;
  a.cand = cand;
  a.e_out = e_out;
  a.bmap = bmap;
  a.wpos = wpos;
  a.wmd = wmd;
  a.launches = launches;
  return dispatch<true>(a, (cudaStream_t)stream);
}
