// access_probe: the Get-path bucket probe with the embedded-history match.
//
// Replaces the Pallas kernel repro/kernels/bucket_lookup.py::access_probe
// (pallas_call at bucket_lookup.py:171).  For each key: splitmix32 ->
// bucket; over the bucket's `assoc` slots, the first live slot holding the
// key (found, slot) and the first valid history entry whose stored hash
// matches (age = (hist_ctr - ptr) mod 2^32 < history_len), masked by
// ~found.  hist_slot is the bucket base when no history entry matches,
// as jnp.argmax of an all-false row gives.
//
// Bound on the H100: bytes.  Each key reads 4 columns x assoc int64 slots
// (256 B at assoc 8) and writes 18 B; at B = 2048 keys that is ~0.5 MB,
// ~0.15 us at 3.35 TB/s, far below one launch's latency.  The design
// keeps it to one thread per key and one pass over the bucket, with the
// hash, the compare and the age arithmetic in 32-bit registers; the
// table stays in device memory (the TPU kernel's whole-table VMEM block
// has no counterpart).  The history counter is read through a pointer so
// the step issues no host sync.  Thread 0 of block 0 adds one to the
// launch counter, so a launch replayed from a CUDA graph is counted too.

#include "common.cuh"

namespace {

__global__ void access_probe_kernel(
    const int64_t* __restrict__ tkey, const int64_t* __restrict__ tsize,
    const int64_t* __restrict__ thash, const int64_t* __restrict__ tptr,
    const int64_t* __restrict__ keys, const int64_t* __restrict__ hist_ctr,
    int n, int assoc, uint32_t n_buckets, uint32_t history_len,
    bool* __restrict__ found, int64_t* __restrict__ slot,
    bool* __restrict__ hfound, int64_t* __restrict__ hslot,
    unsigned long long* __restrict__ launches) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) atomicAdd(launches, 1ull);
  if (b >= n) return;
  const uint32_t key = (uint32_t)keys[b];
  const uint32_t kh = splitmix32(key);
  const int64_t base = (int64_t)(kh % n_buckets) * assoc;
  const uint32_t hctr = (uint32_t)hist_ctr[0];
  int mi = -1, hi = -1;
  for (int a = 0; a < assoc; ++a) {
    const int64_t s = base + a;
    const uint32_t sz = (uint32_t)tsize[s];
    if (mi < 0 && sz > 0u && sz < 255u && (uint32_t)tkey[s] == key) mi = a;
    if (hi < 0 && sz == 255u &&
        (uint32_t)(hctr - (uint32_t)tptr[s]) < history_len &&
        (uint32_t)thash[s] == kh)
      hi = a;
  }
  found[b] = mi >= 0;
  slot[b] = mi >= 0 ? base + mi : -1;
  hfound[b] = hi >= 0 && mi < 0;
  hslot[b] = base + (hi >= 0 ? hi : 0);
}

}  // namespace

extern "C" int access_probe_launch(
    const int64_t* tkey, const int64_t* tsize, const int64_t* thash,
    const int64_t* tptr, const int64_t* keys, const int64_t* hist_ctr, int n,
    int assoc, int64_t n_buckets, int64_t history_len, bool* found,
    int64_t* slot, bool* hfound, int64_t* hslot,
    unsigned long long* launches, void* stream) {
  if (n > 0) {
    const int threads = 256;
    access_probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        tkey, tsize, thash, tptr, keys, hist_ctr, n, assoc,
        (uint32_t)n_buckets, (uint32_t)history_len, found, slot, hfound,
        hslot, launches);
  }
  return (int)cudaGetLastError();
}
