// metadata_update: the combining frequency add and the stateless
// timestamp write of a batch of FC-cache flushes, into fresh columns.
//
// Replaces the Pallas kernel repro/kernels/metadata_update.py::
// metadata_update (pallas_call at metadata_update.py:184).  For every
// batch entry i whose slot s = slots[i] lies in [0, C): freq[s] += the
// deltas of all entries on s, and last_ts[s] = max(last_ts[s], clock),
// also where the delta is 0.  Entries with any other slot (-1 marks a
// no-op) change nothing.
//
// Bound on the H100: bytes.  The update reads the batch (12 B an entry)
// and, at each distinct touched slot, its freq and last_ts, and writes
// both back: ~50 KB at B = 2048, ~0.015 us at 3.35 TB/s, far below one
// launch's latency.  The wrapper copies the input columns into the
// outputs first (the update is out of place, as the JAX kernel returns
// new arrays); that copy moves whole columns and is not part of these
// passes.
//
// The TPU kernel summed each table tile's deltas with a one-hot matmul on
// the MXU.  An f32 atomicAdd would sum them in the order the threads
// arrive, so two launches could differ in the last bit.  Instead every
// launch gives the same bits, and the plain version's: the first entry
// of each slot claims it and adds the slot's deltas one by one in batch
// order, freq + d_1 + d_2 + ..., in three short passes in stream order:
//   1. over entries: reset the slot's claim and count;
//   2. over entries: atomicMin of the entry index into claim[s] and an
//      atomicAdd into count[s];
//   3. one warp per entry, of which only the claimer goes on: it scans
//      the batch after its own index, 256 entries a round trip (eight
//      32-entry chunks loaded at once; __ballot_sync finds the slot's
//      entries), adds their deltas in order until it has seen count[s]
//      of them, and writes freq and last_ts.
// A slot with one entry takes no scan.  A duplicated slot's scan is
// latency-bound, a round trip per 256 entries of the batch span between
// its first and last entry (read one 32-entry chunk a round trip, the
// passes took 15 us, not 7.3, at B = 2048 with two random pairs on an
// H100), and a slot with many entries adds them in a serial chain.  The
// adds round to nearest (__fadd_rn).  Thread 0 of pass 1 adds one to the
// launch counter (pass 1 runs whenever anything does), so a launch
// replayed from a CUDA graph is counted too.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int SCAN = 8;  // 32-entry chunks a claimer reads per round trip

__device__ __forceinline__ bool valid(int64_t s, int64_t C) {
  return s >= 0 && s < C;
}

__global__ void reset_kernel(const int64_t* __restrict__ slots, int n,
                             int64_t C, int* __restrict__ claim,
                             int* __restrict__ count,
                             unsigned long long* __restrict__ launches) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) atomicAdd(launches, 1ull);
  if (i >= n) return;
  const int64_t s = slots[i];
  if (valid(s, C)) {
    claim[s] = 0x7fffffff;
    count[s] = 0;
  }
}

__global__ void claim_kernel(const int64_t* __restrict__ slots, int n,
                             int64_t C, int* __restrict__ claim,
                             int* __restrict__ count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = slots[i];
  if (!valid(s, C)) return;
  atomicMin(claim + s, i);
  atomicAdd(count + s, 1);
}

__global__ void __launch_bounds__(WARPS * 32) sum_kernel(
    const int64_t* __restrict__ slots, const float* __restrict__ deltas,
    int n, int64_t C, const int* __restrict__ claim,
    const int* __restrict__ count, const float* __restrict__ freq_in,
    const float* __restrict__ last_in, const float* __restrict__ clock_ptr,
    float clock_val, float* __restrict__ freq_out,
    float* __restrict__ last_out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // warp-uniform
  const int64_t s = slots[i];
  if (!valid(s, C) || claim[s] != i) return;
  float acc = __fadd_rn(freq_in[s], deltas[i]);
  int left = count[s] - 1;
  for (int base = i + 1; left > 0 && base < n; base += 32 * SCAN) {
    // SCAN chunks of 32 entries: all loads issued first (a ballot is a
    // barrier to the compiler's reordering), then summed in order.
    int64_t sj[SCAN];
    float d[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int j = base + 32 * u + lane;
      sj[u] = j < n ? slots[j] : -1;
      d[u] = j < n ? deltas[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      unsigned m = __ballot_sync(FULL, sj[u] == s);
      left -= __popc(m);
      while (m) {
        acc = __fadd_rn(acc, __shfl_sync(FULL, d[u], __ffs(m) - 1));
        m &= m - 1;
      }
    }
  }
  if (lane == 0) {
    const float c = clock_ptr ? clock_ptr[0] : clock_val;
    const float l = last_in[s];
    freq_out[s] = acc;
    // torch.maximum's rule: a NaN on either side gives NaN.
    last_out[s] = (l != l || l > c) ? l : c;
  }
}

}  // namespace

extern "C" int metadata_update_launch(
    const int64_t* slots, const float* deltas, int n, int64_t C,
    const float* freq_in, const float* last_in, const float* clock_ptr,
    float clock_val, int* claim, int* count, float* freq_out,
    float* last_out, unsigned long long* launches, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    reset_kernel<<<blocks, threads, 0, st>>>(slots, n, C, claim, count,
                                             launches);
    claim_kernel<<<blocks, threads, 0, st>>>(slots, n, C, claim, count);
    sum_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
        slots, deltas, n, C, claim, count, freq_in, last_in, clock_ptr,
        clock_val, freq_out, last_out);
  }
  return (int)cudaGetLastError();
}
