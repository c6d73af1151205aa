// bucket_lookup: the hash-table bucket probe alone, (found, slot) a key.
//
// Replaces the Pallas kernel repro/kernels/bucket_lookup.py::bucket_lookup
// (pallas_call at bucket_lookup.py:98).  For each key: splitmix32 ->
// bucket = hash % n_buckets; over the bucket's `assoc` slots, the first
// live slot (0 < size < 255) holding the key gives (true, slot), and a
// miss gives (false, -1).  n_buckets is floor(C / assoc), as the Pallas
// kernel takes it, so a ragged tail of the table is never probed.
//
// Bound on the H100: bytes.  Each key reads 2 columns x assoc int64 slots
// (128 B at assoc 8) and writes 9 B; at B = 2048 keys that is ~0.3 MB,
// ~0.08 us at 3.35 TB/s, far below one launch's latency.  So what bounds
// a call is its chain of dependent round trips to device memory: the key,
// then the bucket, then the stores.  A thread a key that walks the bucket
// slot by slot, stopping at the first match, adds a round trip a slot
// (and spreads B = 2048 keys over 8 of the 132 SMs).  The design is
// access_probe's: a tile of T lanes of one warp works on each key, T the
// power of two >= assoc (at most 32; a larger bucket is walked in 32-slot
// chunks, in slot order, stopping after the chunk that matched), and each
// lane loads its slot's key and size with no condition on the data, so
// the bucket is one round trip after the key.  __ballot_sync + __ffs give
// the first live match (jnp.argmax's first index), in common.cuh's
// tile_match, the device function access_probe's match is too.  Blocks of
// 128 threads put B = 2048 keys at assoc 8 on 128 SMs.  The table stays
// in device memory (the TPU kernel's whole-table VMEM block has no
// counterpart).  Thread 0 of block 0 adds one to the launch counter, so a
// launch replayed from a CUDA graph is counted too.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) bucket_lookup_kernel(
    const int64_t* __restrict__ tkey, const int64_t* __restrict__ tsize,
    const int64_t* __restrict__ keys, int n, int assoc, int tile,
    uint32_t n_buckets, bool* __restrict__ found, int64_t* __restrict__ slot,
    unsigned long long* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int lane = threadIdx.x & 31;
  const KeyTile t = key_tile(tile);
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int b = warp * (32 / tile) + lane / tile;
  const bool valid = b < n;  // every lane stays for the warp's ballots

  const uint32_t key = valid ? (uint32_t)keys[b] : 0u;
  const int64_t base = (int64_t)(splitmix32(key) % n_buckets) * assoc;
  // More than one chunk only at tile 32, one key a warp: `mi` is then
  // warp-uniform, so the early exit keeps the warp together.
  const int chunks = (assoc + 31) >> 5;
  int mi = -1;
  for (int c = 0; c < chunks && mi < 0; ++c) {
    const int a = (c << 5) + t.sub;
    const bool in = valid && a < assoc;
    const uint32_t sz = in ? (uint32_t)tsize[base + a] : 0u;
    const uint32_t k = in ? (uint32_t)tkey[base + a] : 0u;
    tile_match(mi, in, sz, k, key, c, t);
  }
  if (valid && t.sub == 0) {
    found[b] = mi >= 0;
    slot[b] = mi >= 0 ? base + mi : -1;
  }
}

}  // namespace

extern "C" int bucket_lookup_launch(const int64_t* tkey, const int64_t* tsize,
                                    const int64_t* keys, int n, int assoc,
                                    int64_t n_buckets, bool* found,
                                    int64_t* slot,
                                    unsigned long long* launches,
                                    void* stream) {
  if (n > 0 && assoc > 0) {
    const int tile = probe_tile(assoc);
    const long long per_block = (long long)(THREADS / 32) * (32 / tile);
    const int blocks = (int)((n + per_block - 1) / per_block);
    bucket_lookup_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        tkey, tsize, keys, n, assoc, tile, (uint32_t)n_buckets, found, slot,
        launches);
  }
  return (int)cudaGetLastError();
}
