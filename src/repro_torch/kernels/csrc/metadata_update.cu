// metadata_update: the combining frequency add and the stateless
// timestamp write of a batch of FC-cache flushes, into fresh columns or in
// place.
//
// Replaces the Pallas kernel repro/kernels/metadata_update.py::
// metadata_update (pallas_call at metadata_update.py:184).  For every
// batch entry i whose slot s = slots[i] lies in [0, C): freq[s] += the
// deltas of all entries on s, and last_ts[s] = max(last_ts[s], clock),
// also where the delta is 0.  Entries with any other slot (-1 marks a
// no-op) change nothing.
//
// Bound on the H100: bytes.  In place the update reads the batch (12 B an
// entry) and, at each distinct touched slot, its freq and last_ts, and
// writes both back: ~50 KB at B = 2048, ~0.015 us at 3.35 TB/s, far below
// one launch's latency.  Into fresh outputs it must also copy both whole
// columns (16 MB read, 16 MB written at C = 2,097,152: ~10 us).  So in
// place a call is bound by its chain of round trips and barriers, into
// fresh outputs by the copy; and a slot with many entries by its chain of
// dependent f32 adds, since the sum must keep the plain version's bits:
// freq + d_1 + d_2 + ... in batch order, each add rounded to nearest, as
// JAX's oracle (repro/kernels/ref.py, .at[].add) adds.  A tree sum or an
// f32 atomicAdd would round otherwise.
//
// The design is the Pallas kernel's own shape, one launch: each CTA owns
// a contiguous tile of TILE table slots and reads every slot of the batch
// (from L2 after the first CTA's read), as each Pallas program read the
// batch against its tile with a one-hot matmul.
//   1. Unless an output is its input's own storage (the in-place form),
//      the CTA copies its tile of freq and last_ts into the outputs with
//      16-byte loads and stores; the loads go out before the batch's
//      first round, the stores after it is in flight.
//   2. The batch's slots, ROUND a round (the next round's loads in flight
//      during this one).  Each warp ballots which of its entries fall in
//      the tile, and those entries load their delta and their slot's
//      freq and last_ts at once; one barrier gives every warp its offset,
//      and the entries are packed into shared memory in batch order as
//      (tile slot, delta) and (freq, last_ts); each packed slot's head
//      and tail are reset.
//   3. When the packed entries would overflow CAP, and after the last
//      round, the CTA combines them.  The first and the last entry of
//      each run of equal slots among a warp's 32 consecutive packed
//      entries (two shuffles) mark the slot's first and last packed
//      entry with a shared atomicMin and atomicMax.  After one barrier,
//      the thread of a slot's first entry adds the slot's deltas to its
//      freq in packed (= batch) order in a register, walking the packed
//      entries up to the slot's last, WALK at a time (16-byte loads, the
//      next WALK's in flight; a predicated add, so the chain is the adds
//      alone), and writes freq and last_ts (torch.maximum's rule: a NaN
//      on either side gives NaN).  A combine after the first reloads the
//      running freq and last_ts of the entries packed before it.
// A slot's first entry owns it, so no table-sized scratch is reset or
// claimed and no entry is passed through a shuffle chain; a slot with one
// entry takes no walk.  A slot with m entries in one tile costs a chain
// of m adds; a slot whose entries lie far apart in a crowded tile walks
// the packed entries between them; a crowded tile's scattered loads and
// stores all go through one SM.  Every CTA reads every slot of the batch:
// at C = 2,097,152 that is 128 reads of it from L2, what the call's time
// grows with at large B.  Thread 0 of block 0 adds one to the launch
// counter, so a launch replayed from a CUDA graph is counted too.

#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16384;              // table slots a CTA owns
constexpr int PER = 8;                   // batch slots a thread reads a round
constexpr int ROUND = THREADS * PER;     // batch entries a round
constexpr int CAP = ROUND;               // packed entries held before a combine
constexpr int Q = CAP / THREADS;         // packed entries a thread marks
constexpr int VEC = TILE / 4 / THREADS;  // float4s a thread copies a column
constexpr int WALK = 8;                  // packed entries a walk loads at once

struct Smem {
  int head[TILE];        // a tile slot's first packed entry
  int tail[TILE];        // and its last
  int2 e[CAP];           // packed entries: (tile slot, delta's bits)
  float2 fl[CAP];        // and their slot's running (freq, last_ts)
  int wcount[2][WARPS];  // each warp's in-tile entries, two rounds' worth
};

// acc + the delta (bits) of a packed entry of slot `mine`; another slot's
// entry adds nothing.  A predicated add: written as a select, the
// compiler may put the select after the add, on the walk's chain.
__device__ __forceinline__ float add_if(float acc, int slot, int bits,
                                        int mine) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.rn.f32 %0, %0, %3;\n\t}"
      : "+f"(acc)
      : "r"(slot), "r"(mine), "f"(__int_as_float(bits)));
  return acc;
}

__device__ __forceinline__ void load_walk(int4 (&x)[WALK / 2],
                                          const int2* e) {  // 16-B aligned
#pragma unroll
  for (int u = 0; u < WALK / 2; ++u)
    x[u] = reinterpret_cast<const int4*>(e)[u];
}

__device__ __forceinline__ float add_walk(float acc,
                                          const int4 (&x)[WALK / 2],
                                          int mine) {
#pragma unroll
  for (int u = 0; u < WALK / 2; ++u) {
    acc = add_if(acc, x[u].x, x[u].y, mine);
    acc = add_if(acc, x[u].z, x[u].w, mine);
  }
  return acc;
}

// acc + the deltas of slot `mine` among packed entries [k, end), in
// order: WALK entries at a time, two of them a 16-byte load, the next
// WALK's loads in flight while these are added.
__device__ __forceinline__ float walk(float acc, const int2* e, int k,
                                      int end, int mine) {
  if ((k & 1) && k < end) {
    acc = add_if(acc, e[k].x, e[k].y, mine);
    ++k;
  }
  if (k + WALK <= end) {
    int4 x[WALK / 2], y[WALK / 2];
    load_walk(x, e + k);
    k += WALK;
    for (; k + 2 * WALK <= end; k += 2 * WALK) {
      load_walk(y, e + k);
      acc = add_walk(acc, x, mine);
      load_walk(x, e + k + WALK);
      acc = add_walk(acc, y, mine);
    }
    if (k + WALK <= end) {
      load_walk(y, e + k);
      acc = add_walk(acc, x, mine);
      acc = add_walk(acc, y, mine);
      k += WALK;
    } else {
      acc = add_walk(acc, x, mine);
    }
  }
  for (; k < end; ++k) acc = add_if(acc, e[k].x, e[k].y, mine);
  return acc;
}

__global__ void __launch_bounds__(THREADS, 1) metadata_update_kernel(
    const int64_t* __restrict__ slots, const float* __restrict__ deltas,
    int n, int64_t C, const float* freq_in, const float* last_in,
    const float* __restrict__ clock_ptr, float clock_val, float* freq_out,
    float* last_out, unsigned long long* __restrict__ launches) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) atomicAdd(launches, 1ull);
  const int64_t lo = (int64_t)blockIdx.x * TILE;
  const int64_t hi = lo + TILE < C ? lo + TILE : C;
  const float clock = clock_ptr ? clock_ptr[0] : clock_val;

  // 1. The copy's loads: float4s where all four columns are 16-byte
  // aligned (the tile's base is: TILE is a multiple of 4), the rest of
  // the tile one float at a time.
  const bool copy_f = freq_out != freq_in, copy_l = last_out != last_in;
  const bool vec = ((reinterpret_cast<uintptr_t>(freq_in) |
                     reinterpret_cast<uintptr_t>(freq_out) |
                     reinterpret_cast<uintptr_t>(last_in) |
                     reinterpret_cast<uintptr_t>(last_out)) & 15) == 0;
  const int n4 = vec && hi > lo ? (int)((hi - lo) >> 2) : 0;
  float4 cf[VEC], cl[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int i = v * THREADS + tid;
    if (i < n4) {
      if (copy_f) cf[v] = reinterpret_cast<const float4*>(freq_in + lo)[i];
      if (copy_l) cl[v] = reinterpret_cast<const float4*>(last_in + lo)[i];
    }
  }

  // 2. The batch's slots, in rounds: warp w reads entries w * 32 * PER +
  // u * 32 + lane of each round, so its entries in (u, lane) order are in
  // batch order.
  int64_t s_cur[PER], s_nxt[PER];
  auto load_round = [&](long long base, int64_t (&s)[PER]) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const long long e = base + (warp * PER + u) * 32 + lane;
      s[u] = e < n ? slots[e] : -1;
    }
  };
  load_round(0, s_cur);

  // 1, continued: the copy's stores (ordered before every update by the
  // first round's barrier).
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int i = v * THREADS + tid;
    if (i < n4) {
      if (copy_f) reinterpret_cast<float4*>(freq_out + lo)[i] = cf[v];
      if (copy_l) reinterpret_cast<float4*>(last_out + lo)[i] = cl[v];
    }
  }
  for (int64_t i = lo + 4 * (int64_t)n4 + tid; i < hi; i += THREADS) {
    if (copy_f) freq_out[i] = freq_in[i];
    if (copy_l) last_out[i] = last_in[i];
  }

  // 3. Combine the m packed entries into the outputs.  The first combine
  // takes the values its entries loaded when they were read (before any
  // update, an output slot holds its input's value); a later one reloads
  // them from the outputs.
  auto combine = [&](int m, bool first, bool final) {
    __syncthreads();  // the packed entries are in place
    int ls[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = q * THREADS + tid;
      ls[q] = j < m ? sm.e[j].x : -1;
      if (!first && ls[q] >= 0)
        sm.fl[j] = make_float2(freq_out[lo + ls[q]], last_out[lo + ls[q]]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      // A warp's entries of one q are consecutive: only the first entry
      // of a run of equal slots among them can be its slot's first, only
      // the run's last its last.
      const int up = __shfl_up_sync(FULL, ls[q], 1);
      const int dn = __shfl_down_sync(FULL, ls[q], 1);
      const int j = q * THREADS + tid;
      if (ls[q] >= 0 && (lane == 0 || up != ls[q]))
        atomicMin(&sm.head[ls[q]], j);
      if (ls[q] >= 0 && (lane == 31 || dn != ls[q]))
        atomicMax(&sm.tail[ls[q]], j);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = tid; j < m; j += THREADS) {
      const int2 x = sm.e[j];
      if (sm.head[x.x] != j) continue;
      const float2 fl = sm.fl[j];
      const float acc = walk(__fadd_rn(fl.x, __int_as_float(x.y)), sm.e,
                             j + 1, sm.tail[x.x] + 1, x.x);
      freq_out[lo + x.x] = acc;
      last_out[lo + x.x] = (fl.y != fl.y || fl.y > clock) ? fl.y : clock;
    }
    if (!final) __syncthreads();  // before the packed entries are reused
  };

  int m = 0, parity = 0;
  bool first = true;
  for (long long base = 0; base < n; base += ROUND, parity ^= 1) {
    if (base + ROUND < n) load_round(base + ROUND, s_nxt);
    unsigned in[PER];
    float f0[PER], l0[PER], d0[PER];
    int wc = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool mine = s_cur[u] >= lo && s_cur[u] < hi;
      in[u] = __ballot_sync(FULL, mine);
      wc += __popc(in[u]);
      if (mine) {
        f0[u] = freq_in[s_cur[u]];
        l0[u] = last_in[s_cur[u]];
        d0[u] = deltas[base + (warp * PER + u) * 32 + lane];
      }
    }
    if (lane == 0) sm.wcount[parity][warp] = wc;
    __syncthreads();
    int off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = sm.wcount[parity][w];
      off += w < warp ? c : 0;
      tot += c;
    }
    if (m + tot > CAP) {  // block-uniform
      combine(m, first, false);
      first = false;
      m = 0;
    }
    int pos = m + off;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if ((in[u] >> lane) & 1u) {
        const int t = (int)(s_cur[u] - lo);
        const int p = pos + __popc(in[u] & ((1u << lane) - 1u));
        sm.e[p] = make_int2(t, __float_as_int(d0[u]));
        sm.fl[p] = make_float2(f0[u], l0[u]);
        sm.head[t] = INT_MAX;
        sm.tail[t] = -1;
      }
      pos += __popc(in[u]);
    }
    m += tot;
#pragma unroll
    for (int u = 0; u < PER; ++u) s_cur[u] = s_nxt[u];
  }
  if (m > 0) combine(m, first, true);
}

}  // namespace

// freq_out and last_out are either fresh columns, written whole, or the
// inputs' own storage (the update in place, with no copy).
extern "C" int metadata_update_launch(
    const int64_t* slots, const float* deltas, int n, int64_t C,
    const float* freq_in, const float* last_in, const float* clock_ptr,
    float clock_val, float* freq_out, float* last_out,
    unsigned long long* launches, void* stream) {
  if (n > 0) {
    const int64_t tiles = (C + TILE - 1) / TILE;
    const int bytes = (int)sizeof(Smem);
    cudaFuncSetAttribute(metadata_update_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    metadata_update_kernel<<<(unsigned)(tiles > 0 ? tiles : 1), THREADS,
                             bytes, (cudaStream_t)stream>>>(
        slots, deltas, n, C, freq_in, last_in, clock_ptr, clock_val,
        freq_out, last_out, launches);
  }
  return (int)cudaGetLastError();
}
