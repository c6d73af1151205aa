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
// ~0.08 us at 3.35 TB/s, far below one launch's latency.  The design is
// access_probe's without the history match: one thread per key, one pass
// over the bucket, the hash and the compare in 32-bit registers; the
// table stays in device memory (the TPU kernel's whole-table VMEM block
// has no counterpart).  Thread 0 of block 0 adds one to the launch
// counter, so a launch replayed from a CUDA graph is counted too.

#include "common.cuh"

namespace {

__global__ void bucket_lookup_kernel(
    const int64_t* __restrict__ tkey, const int64_t* __restrict__ tsize,
    const int64_t* __restrict__ keys, int n, int assoc, uint32_t n_buckets,
    bool* __restrict__ found, int64_t* __restrict__ slot,
    unsigned long long* __restrict__ launches) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) atomicAdd(launches, 1ull);
  if (b >= n) return;
  const uint32_t key = (uint32_t)keys[b];
  const int64_t base = (int64_t)(splitmix32(key) % n_buckets) * assoc;
  int mi = -1;
  for (int a = 0; a < assoc && mi < 0; ++a) {
    const uint32_t sz = (uint32_t)tsize[base + a];
    if (sz > 0u && sz < 255u && (uint32_t)tkey[base + a] == key) mi = a;
  }
  found[b] = mi >= 0;
  slot[b] = mi >= 0 ? base + mi : -1;
}

}  // namespace

extern "C" int bucket_lookup_launch(const int64_t* tkey, const int64_t* tsize,
                                    const int64_t* keys, int n, int assoc,
                                    int64_t n_buckets, bool* found,
                                    int64_t* slot,
                                    unsigned long long* launches,
                                    void* stream) {
  if (n > 0) {
    const int threads = 256;
    bucket_lookup_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
        tkey, tsize, keys, n, assoc, (uint32_t)n_buckets, found, slot,
        launches);
  }
  return (int)cudaGetLastError();
}
