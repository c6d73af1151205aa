// drop_scatter: in-place row writes into up to MAX_COLS table columns that
// share one index array, dropping out-of-range indices.
//
// For each column c and entry i with 0 <= idx[i] < n_rows:
//   col_c[idx[i], :] = src_c[i, :]   (or the fill value where src_c is null)
// and nothing for any other index.  This is the cache step's apply.  It
// replaces no Pallas kernel: the JAX package leaves these scatters
// (repro/core/cache.py:601-602 and :636-651, the SET, insert and eviction
// writes `.at[idx].set(src, mode="drop")`) to XLA, which does them in
// place.  In-range indices are unique, or their entries write equal rows
// (the caller resolves duplicates first), so the result does not depend
// on the order the threads write in.
//
// Bound on the H100: bytes, of the touched rows only: each index read
// once, each in-range entry's source row read once and its destination
// row written once (at B = 2048 entries a few hundred KB at most, far
// below one launch's latency).  One thread per entry walks the columns and
// the row; one launch serves every column of a write group, so a cache
// step's apply is three launches.  Rows are copied as 4- or 8-byte words
// (int64 and f32 columns).  Thread 0 adds one to the launch counter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COLS = 12;

struct Cols {
  void* dst[MAX_COLS];
  const void* src[MAX_COLS];   // null: every row is `fill`
  long long fill[MAX_COLS];
  int width[MAX_COLS];         // words a row
  int word[MAX_COLS];          // bytes a word: 4 or 8
};

__global__ void drop_scatter_kernel(const int64_t* __restrict__ idx, int n_idx,
                                    long long n_rows, int n_cols, Cols c,
                                    unsigned long long* __restrict__ launches) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) atomicAdd(launches, 1ull);
  if (i >= n_idx) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) return;
  for (int k = 0; k < n_cols; ++k) {
    const int w = c.width[k];
    if (c.word[k] == 8) {
      uint64_t* d = static_cast<uint64_t*>(c.dst[k]) + r * w;
      const uint64_t* s = static_cast<const uint64_t*>(c.src[k]);
      for (int j = 0; j < w; ++j)
        d[j] = s ? s[(int64_t)i * w + j] : (uint64_t)c.fill[k];
    } else {
      uint32_t* d = static_cast<uint32_t*>(c.dst[k]) + r * w;
      const uint32_t* s = static_cast<const uint32_t*>(c.src[k]);
      for (int j = 0; j < w; ++j)
        d[j] = s ? s[(int64_t)i * w + j] : (uint32_t)c.fill[k];
    }
  }
}

}  // namespace

extern "C" int drop_scatter_launch(const int64_t* idx, int n_idx,
                                   long long n_rows, int n_cols,
                                   void* const* dst, const void* const* src,
                                   const long long* fill, const int* width,
                                   const int* word,
                                   unsigned long long* launches,
                                   void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  Cols c = {};
  for (int k = 0; k < n_cols; ++k) {
    c.dst[k] = dst[k];
    c.src[k] = src[k];
    c.fill[k] = fill[k];
    c.width[k] = width[k];
    c.word[k] = word[k];
  }
  const int threads = 256;
  const int blocks = n_idx > 0 ? (n_idx + threads - 1) / threads : 1;
  drop_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      idx, n_idx, n_rows, n_cols, c, launches);
  return (int)cudaGetLastError();
}
