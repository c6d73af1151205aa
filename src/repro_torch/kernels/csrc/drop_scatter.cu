// drop_scatter: in-place row writes of an ordered list of write groups in
// one launch.  A group is an index array, an optional keep mask and the
// table columns it writes; out-of-range or masked entries are dropped.
//
// For group g = 0, 1, ... in order, each column c of g and each entry i
// with mask[i] (or no mask) and 0 <= idx[i] < n_rows:
//   col_c[idx[i], :] = src_c[i, :]
// where a source is a tensor row, a fill value, or a select of two such
// (cond[i] ? a : b).  A later group's write of a (slot, column) wins over
// an earlier one's.  This is the cache step's apply: the SET, the inserts
// and the evictions, in the JAX package's order.  The kernel
// replaces no Pallas kernel: the JAX package leaves these scatters
// (repro/core/cache.py:601-602 and :636-651, `.at[idx].set(src,
// mode="drop")`) to XLA, which does them in place.  Within a group,
// in-range indices are unique, or their entries write equal rows (the
// caller resolves duplicates first), so the result does not depend on the
// order the threads write in.
//
// Bound on the H100: bytes, of the touched rows only: each index (and
// mask) read once, each kept entry's source row read once and its
// destination row written once (at the cache step's B = 2048 and
// B * K = 10,240 entries a few hundred KB, far below one launch's
// latency).  What costs is latency: the writes land on random rows of
// columns far larger than L2, and one SM has only so many stores in
// flight.  So the design spreads each group over blocks of 128 entries
// (the cache step's three groups take 112 blocks) and orders the groups
// without a second launch: a block takes a ticket from a device counter
// as it starts (blocks of earlier groups get earlier tickets), loads its
// entries' indices and masks, compacts the kept ones in shared memory,
// and loads the first batch of their (entry, word) sources; only then,
// and only if it has anything to write, does it wait until every block
// of every earlier group has finished its stores (a done count a group,
// after a fence), and store.  A block waits only on blocks with
// earlier tickets, which are already running and wait on nothing later,
// so the wait cannot deadlock however many blocks are resident.  The
// last block to finish sets the counters back to 0 for the next launch,
// so launches on one device must not overlap (they run on one stream).
// Sources are not written by the launch.  Words are 4 or 8 bytes (f32 and
// int64 columns).  The kernel takes its plan as a __grid_constant__
// parameter, so the columns are indexed in place, with no copy.  Thread 0
// of block 0 adds one to the launch counter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_GROUPS = 4;
constexpr int MAX_COLS = 16;      // over all groups
constexpr int TILE = 128;         // entries, and threads, a block
constexpr int BATCH = 8;          // (entry, word) pairs a thread loads at once
// sync[]: the ticket counter, a done count a group, the finished blocks.
constexpr int SYNC_WORDS = 2 + MAX_GROUPS;

struct Col {
  void* dst;
  int width;                      // words a row
  int word;                       // bytes a word: 4 or 8
  const bool* cond;               // null: every entry takes a
  const void* a;                  // null: a_fill
  const void* b;                  // null: b_fill
  long long a_fill, b_fill;
};

struct Group {
  const int64_t* idx;
  const bool* mask;               // null: keep every entry
  int n;                          // entries
  int col0, ncols, words;         // its columns, and their words a row
  int block0, blocks;             // its tickets
  long long rows;                 // the columns' length
};

struct Plan {
  Group g[MAX_GROUPS];
  Col c[MAX_COLS];
  int ngroups, blocks;
};

__device__ __forceinline__ uint64_t word_at(const void* p, long long fill,
                                            int64_t at, int word) {
  if (!p) return (uint64_t)fill;
  return word == 8 ? static_cast<const uint64_t*>(p)[at]
                   : (uint64_t) static_cast<const uint32_t*>(p)[at];
}

__global__ void __launch_bounds__(TILE)
    drop_scatter_kernel(const __grid_constant__ Plan p,
                        unsigned* __restrict__ sync,
                        unsigned long long* __restrict__ launches) {
  __shared__ int s_e[TILE];       // the block's kept entries
  __shared__ int s_r[TILE];       // and their rows
  __shared__ int s_n, s_ticket;
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (blockIdx.x == 0 && t == 0) atomicAdd(launches, 1ull);
  if (t == 0) {
    s_ticket = (int)atomicAdd(&sync[0], 1u);
    s_n = 0;
  }
  __syncthreads();
  const int ticket = s_ticket;
  int gi = 0;
  while (gi + 1 < p.ngroups && ticket >= p.g[gi + 1].block0) ++gi;
  const Group& g = p.g[gi];

  if (ticket < p.blocks) {
    // 1. The tile's index and mask; the kept entries compacted.
    const int e = (ticket - g.block0) * TILE + t;
    int64_t r = -1;
    bool ok = e < g.n;
    if (ok) {
      r = g.idx[e];
      if (g.mask) ok = g.mask[e];
    }
    ok = ok && r >= 0 && r < g.rows;
    const unsigned m = __ballot_sync(FULL, ok);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&s_n, __popc(m));
    at = __shfl_sync(FULL, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (ok) {
      s_e[at] = e;
      s_r[at] = (int)r;
    }
    __syncthreads();

    // 2. The kept entries' words: pair q is word q / kept of entry
    //    q % kept; a batch's loads go out before its stores, and the
    //    first batch's before the wait for the earlier groups.
    const int kept = s_n;
    const int pairs = kept * g.words;
    for (int q0 = 0; q0 < pairs; q0 += BATCH * TILE) {
      uint64_t v[BATCH];
      char* d[BATCH];
      int wb[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int q = q0 + u * TILE + t;
        d[u] = nullptr;
        wb[u] = 8;
        v[u] = 0;
        if (q < pairs) {
          int j = q / kept;
          const int li = q - j * kept;
          int c = g.col0;
          while (j >= p.c[c].width) j -= p.c[c++].width;
          const Col& col = p.c[c];
          const int ei = s_e[li];
          const int64_t src = (int64_t)ei * col.width + j;
          const uint64_t a = word_at(col.a, col.a_fill, src, col.word);
          const uint64_t b =
              col.cond ? word_at(col.b, col.b_fill, src, col.word) : 0;
          const bool take_a = !col.cond || col.cond[ei];
          v[u] = take_a ? a : b;
          wb[u] = col.word;
          d[u] = static_cast<char*>(col.dst) +
                 ((int64_t)s_r[li] * col.width + j) * col.word;
        }
      }
      if (q0 == 0 && gi > 0) {
        // Every block of every earlier group has stored and fenced.
        if (t == 0) {
          for (int h = 0; h < gi; ++h)
            while (*(volatile unsigned*)&sync[1 + h] <
                   (unsigned)p.g[h].blocks)
              __nanosleep(32);
          __threadfence();
        }
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (!d[u]) continue;
        if (wb[u] == 8)
          *reinterpret_cast<unsigned long long*>(d[u]) = v[u];
        else
          *reinterpret_cast<unsigned*>(d[u]) = (unsigned)v[u];
      }
    }
    // Done: the block's stores, then its count (a block that stored
    // nothing, or of the last group, which no one waits on, needs no
    // fence; thread 0's fence after the barrier covers the whole block's
    // stores).
    __syncthreads();
    if (t == 0) {
      if (pairs > 0 && gi + 1 < p.ngroups) __threadfence();
      atomicAdd(&sync[1 + gi], 1u);
    }
  }
  // The last block to finish resets the counters: every other block has
  // passed its wait by then.
  if (t == 0 && atomicAdd(&sync[1 + MAX_GROUPS], 1u) == gridDim.x - 1) {
    for (int k = 0; k < SYNC_WORDS; ++k) sync[k] = 0;
    __threadfence();
  }
}

}  // namespace

extern "C" int drop_scatter_launch(
    int n_groups, const int64_t* const* idx, const bool* const* mask,
    const int* n, const long long* rows, const int* ncols, void* const* dst,
    const int* width, const int* word, const bool* const* cond,
    const void* const* a, const long long* a_fill, const void* const* b,
    const long long* b_fill, unsigned* sync, unsigned long long* launches,
    void* stream) {
  if (n_groups < 1 || n_groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  Plan p = {};
  p.ngroups = n_groups;
  int c = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (ncols[g] < 1 || c + ncols[g] > MAX_COLS || n[g] < 0)
      return (int)cudaErrorInvalidValue;
    const int blocks = (n[g] + TILE - 1) / TILE;
    p.g[g] = {idx[g], mask[g], n[g], c, ncols[g], 0, p.blocks, blocks,
              rows[g]};
    p.blocks += blocks;
    for (int k = 0; k < ncols[g]; ++k, ++c) {
      if (word[c] != 4 && word[c] != 8) return (int)cudaErrorInvalidValue;
      p.c[c] = {dst[c], width[c], word[c], cond[c], a[c], b[c], a_fill[c],
                b_fill[c]};
      p.g[g].words += width[c];
    }
  }
  drop_scatter_kernel<<<p.blocks > 0 ? p.blocks : 1, TILE, 0,
                        (cudaStream_t)stream>>>(p, sync, launches);
  return (int)cudaGetLastError();
}
