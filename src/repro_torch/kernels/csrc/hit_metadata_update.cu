// hit_metadata_update: the hit-side metadata write plus the FC-cache
// frequency FAA, into fresh output columns.
//
// Replaces the Pallas kernel repro/kernels/metadata_update.py::
// hit_metadata_update (pallas_call at metadata_update.py:154).  At hit
// slots: last_ts = max(last_ts, ts_eff) and the extension columns
// (LRU-K ring slot (freq+1) mod 2, LRFU crf = 1 + crf * 2^(-0.05 gap),
// LIRS irr = gap), all from the step-entry freq / last_ts / ext, where
// ts_eff is the max request timestamp among the step's hits on the slot.
// At FC-flush slots: freq += delta (u32 wrap).
//
// Bound on the H100: bytes.  The work reads and writes only the touched
// slots (40 B of metadata per hit, 8 B per emit); at B = 2048 hits that
// is ~0.2 MB, well under a microsecond and far below one launch's
// latency.  The TPU kernel's tile-wide one-hot matmul has no role here:
// three short passes in stream order replace it.
//   1. over hits and emits: reset the per-slot scratch at hit slots, and
//      the FAA as a 32-bit atomicAdd on the low word of the int64 freq
//      (little-endian; the value stays in [0, 2^32), so the add wraps as
//      u32 does and is exact in any order);
//   2. over hits: atomicMax of the hit timestamp into ts_eff[slot] and an
//      atomicMin claim of the hit index, so exactly one thread per slot
//      writes in pass 3 (duplicate hits must not read each other's output);
//   3. over claimed hits: the last_ts / ext write from step-entry values.
// The wrapper copies the step-entry columns into the outputs first: the
// eviction later in the step reads the step-entry table.  That copy moves
// whole columns and is not part of these passes.  Thread 0 of pass 1 adds
// one to the launch counter (pass 1 runs whenever anything does), so a
// launch replayed from a CUDA graph is counted too.  f32 arithmetic
// uses the explicit round-to-nearest intrinsics, so nvcc never contracts
// a multiply-add into an FMA the plain version does not do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void init_and_faa_kernel(
    const int64_t* __restrict__ hit_slots, int n_hit,
    const int64_t* __restrict__ emit_slots,
    const int64_t* __restrict__ emit_deltas, int n_emit,
    unsigned int* __restrict__ ts_eff, int* __restrict__ claim,
    int64_t* __restrict__ freq_out,
    unsigned long long* __restrict__ launches) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) atomicAdd(launches, 1ull);
  if (i < n_hit) {
    const int64_t s = hit_slots[i];
    if (s >= 0) {
      ts_eff[s] = 0u;
      claim[s] = 0x7fffffff;
    }
  }
  if (i < n_emit) {
    const int64_t s = emit_slots[i];
    if (s >= 0)
      atomicAdd(reinterpret_cast<unsigned int*>(freq_out + s),
                (unsigned int)emit_deltas[i]);
  }
}

__global__ void combine_kernel(const int64_t* __restrict__ hit_slots,
                               const int64_t* __restrict__ hit_ts, int n_hit,
                               unsigned int* __restrict__ ts_eff,
                               int* __restrict__ claim) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_hit) return;
  const int64_t s = hit_slots[i];
  if (s < 0) return;
  atomicMax(ts_eff + s, (unsigned int)hit_ts[i]);
  atomicMin(claim + s, i);
}

__global__ void write_kernel(
    const int64_t* __restrict__ hit_slots, int n_hit,
    const unsigned int* __restrict__ ts_eff, const int* __restrict__ claim,
    const int64_t* __restrict__ freq_in, const int64_t* __restrict__ last_in,
    const float* __restrict__ ext_in, int64_t* __restrict__ last_out,
    float* __restrict__ ext_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_hit) return;
  const int64_t s = hit_slots[i];
  if (s < 0 || claim[s] != i) return;
  const unsigned int t = ts_eff[s];
  const unsigned int last = (unsigned int)last_in[s];
  const unsigned int fr = (unsigned int)freq_in[s];
  last_out[s] = (int64_t)(last > t ? last : t);

  const float clock_f = __uint2float_rn(t);
  const float widx = fmodf(__fadd_rn(__uint2float_rn(fr), 1.0f), 2.0f);
  const float* e = ext_in + 4 * s;
  const float gap = __fsub_rn(clock_f, __uint2float_rn(last));
  // 2^x as XLA lowers jnp.exp2: exp(f32(ln 2) * x).
  const float decay = expf(__fmul_rn(0x1.62e430p-1f, __fmul_rn(-0.05f, gap)));
  const float crf = __fadd_rn(1.0f, __fmul_rn(e[2], decay));
  float* o = ext_out + 4 * s;
  o[0] = widx == 0.0f ? clock_f : e[0];
  o[1] = widx == 1.0f ? clock_f : e[1];
  o[2] = crf;
  o[3] = gap;
}

}  // namespace

extern "C" int hit_metadata_update_launch(
    const int64_t* freq_in, const int64_t* last_in, const float* ext_in,
    const int64_t* hit_slots, const int64_t* hit_ts, int n_hit,
    const int64_t* emit_slots, const int64_t* emit_deltas, int n_emit,
    unsigned int* ts_eff, int* claim, int64_t* freq_out, int64_t* last_out,
    float* ext_out, unsigned long long* launches, void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  const int n1 = n_hit > n_emit ? n_hit : n_emit;
  if (n1 > 0) {
    init_and_faa_kernel<<<(n1 + threads - 1) / threads, threads, 0, st>>>(
        hit_slots, n_hit, emit_slots, emit_deltas, n_emit, ts_eff, claim,
        freq_out, launches);
  }
  if (n_hit > 0) {
    const int blocks = (n_hit + threads - 1) / threads;
    combine_kernel<<<blocks, threads, 0, st>>>(hit_slots, hit_ts, n_hit,
                                               ts_eff, claim);
    write_kernel<<<blocks, threads, 0, st>>>(hit_slots, n_hit, ts_eff, claim,
                                             freq_in, last_in, ext_in,
                                             last_out, ext_out);
  }
  return (int)cudaGetLastError();
}
