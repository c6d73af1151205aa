// access_probe: the Get-path bucket probe with the embedded-history match,
// and, for the cache step, the insert path's facts about the same bucket.
//
// Replaces the Pallas kernel repro/kernels/bucket_lookup.py::access_probe
// (pallas_call at bucket_lookup.py:171).  For each key: splitmix32 ->
// bucket; over the bucket's `assoc` slots, the first live slot holding the
// key (found, slot) and the first valid history entry whose stored hash
// matches (age = (hist_ctr - ptr) mod 2^32 < history_len), masked by
// ~found.  hist_slot is the bucket base when no history entry matches,
// as jnp.argmax of an all-false row gives.
//
// With the facts (a non-null `ins`), from the same loads, what the cache
// step's insert path ranks in the same bucket (core/cache.py): the key's
// hash and bucket; the first free slot (empty, or history past
// history_len) and whether there is one; the oldest valid history entry
// (argmax of its age as f32, first index on ties) and whether there is
// one; whether a live slot exists; and cand[b, e], each expert's argmin
// over the live slots at the op's own timestamp ts[b] (first index on
// ties), with cand[b, E] the first live slot: what the reference
// backend's argmin takes when the op's expert choice is E (its gather
// reads NaN, and argmin returns the first NaN).  Every slot that no rule
// picks is the bucket base, as the argmin or argmax of a row with no
// candidate gives.
//
// Bound on the H100: bytes.  Each key reads 4 columns x assoc int64 slots
// (256 B at assoc 8; 7 columns, 448 B, with the facts) and writes 18 B
// (~80 B with the facts); at B = 2048 keys that is ~0.5 MB (~1.1 MB),
// 0.15-0.35 us at 3.35 TB/s, far below one launch's latency.  So the
// design cuts round trips: a tile of T lanes of one warp works on one key,
// T the power of two >= assoc (at most 32; a larger bucket is walked in
// 32-slot chunks, in slot order), and each lane loads its slot's words
// with no condition, so the bucket is one dependent round trip after the
// hash.  __ballot_sync + __ffs give the first match (jnp.argmax's first
// index); tile shuffles give the argmins.  The hash, the compares and the
// age stay in 32-bit registers; f32 priorities use the round-to-nearest
// intrinsics, as ranked_eviction's do.  The table stays in device memory
// (the TPU kernel's whole-table VMEM block has no counterpart).  The
// history counter is read through a pointer so the step issues no host
// sync.  Thread 0 of block 0 adds one to the launch counter, so a launch
// replayed from a CUDA graph is counted too.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Facts {                 // all null: the probe alone
  const int64_t* ins;          // the table's insert_ts, last_ts, freq
  const int64_t* last;
  const int64_t* freq;
  const int64_t* ts;           // [B] each op's timestamp (u32)
  const int* codes;            // [E] expert codes
  int E;
  int64_t* key_hash;           // [B]
  int64_t* bucket;             // [B]
  int64_t* free_slot;          // [B]
  bool* has_free;              // [B]
  int64_t* hist_slot;          // [B] the oldest valid history entry
  bool* has_hist;              // [B]
  bool* has_live;              // [B]
  int64_t* cand;               // [B, E + 1]
};

template <bool FACTS>
__global__ void __launch_bounds__(THREADS) access_probe_kernel(
    const int64_t* __restrict__ tkey, const int64_t* __restrict__ tsize,
    const int64_t* __restrict__ thash, const int64_t* __restrict__ tptr,
    const int64_t* __restrict__ keys, const int64_t* __restrict__ hist_ctr,
    int n, int assoc, int tile, uint32_t n_buckets, uint32_t history_len,
    bool* __restrict__ found, int64_t* __restrict__ slot,
    bool* __restrict__ hfound, int64_t* __restrict__ hslot, Facts f,
    unsigned long long* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (tile - 1);
  const int tbase = lane - sub;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int b = warp * (32 / tile) + lane / tile;
  const bool valid = b < n;  // every lane stays for the warp's ballots
  const unsigned tmask = tile == 32 ? FULL : ((1u << tile) - 1u) << tbase;

  const uint32_t key = valid ? (uint32_t)keys[b] : 0u;
  const uint32_t kh = splitmix32(key);
  const int64_t base = (int64_t)(kh % n_buckets) * assoc;
  const uint32_t hctr = (uint32_t)hist_ctr[0];
  const float clock =
      FACTS && valid ? __uint2float_rn((unsigned)f.ts[b]) : 0.f;
  // The expert codes ride on the lanes, 32 at a time, loaded with the
  // bucket: the expert loop issues no load behind its own stores.
  int lane_code = FACTS && lane < f.E ? f.codes[lane] : 0;
  const int chunks = (assoc + 31) >> 5;

  // The lane's slot of chunk c: the probe's four words, and with the
  // facts the metadata for the priorities (all loads before any use).
  uint32_t sz = 0u, k = 0u, h = 0u, p = 0u;
  float fsz = 0.f, fins = 0.f, flast = 0.f, ffr = 0.f;
  auto load = [&](int c) {
    const int a = (c << 5) + sub;
    sz = k = h = p = 0u;
    if (valid && a < assoc) {
      const int64_t s = base + a;
      sz = (uint32_t)tsize[s];
      k = (uint32_t)tkey[s];
      h = (uint32_t)thash[s];
      p = (uint32_t)tptr[s];
      if (FACTS) {
        fins = __uint2float_rn((unsigned)f.ins[s]);
        flast = __uint2float_rn((unsigned)f.last[s]);
        ffr = __uint2float_rn((unsigned)f.freq[s]);
      }
    }
    fsz = __uint2float_rn(sz);
  };

  // Pass 1, chunk by chunk: the firsts by ballot, the oldest valid history
  // entry as an argmin of -age (invalid entries +inf, at their position,
  // so a bucket with none gives position 0).
  int mi = -1, hi = -1, fi = -1, li = -1;
  bool any_hist = false;
  float hv = CUDART_INF_F;
  int hix = 0x7fffffff;
  for (int c = 0; c < chunks; ++c) {
    load(c);
    const int a = (c << 5) + sub;
    const bool in = valid && a < assoc;
    const bool live = in && sz > 0u && sz < 255u;
    const bool hist = in && sz == 255u;
    const uint32_t age = hctr - p;
    const bool hvalid = hist && age < history_len;
    const unsigned m_match = __ballot_sync(FULL, live && k == key) & tmask;
    const unsigned m_hist = __ballot_sync(FULL, hvalid && h == kh) & tmask;
    if (mi < 0 && m_match) mi = (c << 5) + __ffs(m_match >> tbase) - 1;
    if (hi < 0 && m_hist) hi = (c << 5) + __ffs(m_hist >> tbase) - 1;
    if (FACTS) {
      const unsigned m_free =
          __ballot_sync(FULL, in && (sz == 0u || (hist && !hvalid))) & tmask;
      const unsigned m_live = __ballot_sync(FULL, live) & tmask;
      any_hist |= (__ballot_sync(FULL, hvalid) & tmask) != 0u;
      if (fi < 0 && m_free) fi = (c << 5) + __ffs(m_free >> tbase) - 1;
      if (li < 0 && m_live) li = (c << 5) + __ffs(m_live >> tbase) - 1;
      const float v = hvalid ? -__uint2float_rn(age) : CUDART_INF_F;
      if (in && (v < hv || (v == hv && a < hix))) {
        hv = v;
        hix = a;
      }
    }
  }

  // Pass 2 (the facts): each expert's argmin over the live slots at the
  // op's clock, from the registers when the bucket is one chunk.
  if (FACTS) {
    tile_argmin(hv, hix, tile);
    for (int e = 0; e < f.E; ++e) {
      if (e > 0 && (e & 31) == 0)
        lane_code = e + lane < f.E ? f.codes[e + lane] : 0;
      const int code = __shfl_sync(FULL, lane_code, e & 31);
      float v = CUDART_INF_F;
      int ix = 0x7fffffff;
      for (int c = 0; c < chunks; ++c) {
        if (chunks > 1) load(c);
        const int a = (c << 5) + sub;
        if (valid && a < assoc) {
          const float pr = sz > 0u && sz < 255u
                               ? priority(code, fsz, fins, flast, ffr, clock)
                               : CUDART_INF_F;
          if (pr < v || (pr == v && a < ix)) {
            v = pr;
            ix = a;
          }
        }
      }
      tile_argmin(v, ix, tile);
      if (valid && sub == 0) f.cand[(int64_t)b * (f.E + 1) + e] = base + ix;
    }
  }

  if (valid && sub == 0) {
    found[b] = mi >= 0;
    slot[b] = mi >= 0 ? base + mi : -1;
    hfound[b] = hi >= 0 && mi < 0;
    hslot[b] = base + (hi >= 0 ? hi : 0);
    if (FACTS) {
      f.key_hash[b] = kh;
      f.bucket[b] = base / assoc;
      f.free_slot[b] = base + (fi >= 0 ? fi : 0);
      f.has_free[b] = fi >= 0;
      f.hist_slot[b] = base + hix;
      f.has_hist[b] = any_hist;
      f.has_live[b] = li >= 0;
      f.cand[(int64_t)b * (f.E + 1) + f.E] = base + (li >= 0 ? li : 0);
    }
  }
}

}  // namespace

extern "C" int access_probe_launch(
    const int64_t* tkey, const int64_t* tsize, const int64_t* thash,
    const int64_t* tptr, const int64_t* keys, const int64_t* hist_ctr, int n,
    int assoc, int64_t n_buckets, int64_t history_len, bool* found,
    int64_t* slot, bool* hfound, int64_t* hslot, const int64_t* ins,
    const int64_t* last, const int64_t* freq, const int64_t* ts,
    const int* codes, int E, int64_t* key_hash, int64_t* bucket,
    int64_t* free_slot, bool* has_free, int64_t* hist_slot, bool* has_hist,
    bool* has_live, int64_t* cand, unsigned long long* launches,
    void* stream) {
  if (n > 0 && assoc > 0) {
    int tile = 1;
    while (tile < assoc && tile < 32) tile <<= 1;
    const long long per_block = (long long)(THREADS / 32) * (32 / tile);
    const int blocks = (int)((n + per_block - 1) / per_block);
    const Facts f = {ins,    last,      freq,     ts,        codes,
                     E,      key_hash,  bucket,   free_slot, has_free,
                     hist_slot, has_hist, has_live, cand};
    if (ins) {
      access_probe_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          tkey, tsize, thash, tptr, keys, hist_ctr, n, assoc, tile,
          (uint32_t)n_buckets, (uint32_t)history_len, found, slot, hfound,
          hslot, f, launches);
    } else {
      access_probe_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          tkey, tsize, thash, tptr, keys, hist_ctr, n, assoc, tile,
          (uint32_t)n_buckets, (uint32_t)history_len, found, slot, hfound,
          hslot, f, launches);
    }
  }
  return (int)cudaGetLastError();
}
