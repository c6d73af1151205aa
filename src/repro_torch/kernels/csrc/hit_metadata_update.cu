// hit_metadata_update: the hit-side metadata write plus the FC-cache
// frequency FAA, in place in the table's own freq / last_ts / ext columns.
//
// Replaces the Pallas kernel repro/kernels/metadata_update.py::
// hit_metadata_update (pallas_call at metadata_update.py:154).  At hit
// slots: last_ts = max(last_ts, ts_eff) and the extension columns
// (LRU-K ring slot (freq+1) mod 2, LRFU crf = 1 + crf * 2^(-0.05 gap),
// LIRS irr = gap), all from the step-entry freq / last_ts / ext, where
// ts_eff is the max request timestamp among the step's hits on the slot.
// At FC-flush slots: freq += delta (u32 wrap).
//
// Bound on the H100: bytes, of the touched slots only.  The work reads
// and writes 40 B of metadata per distinct hit slot and 16 B per distinct
// flush slot; at B = 2048 hits that is ~0.2 MB, well under a microsecond
// and far below one launch's latency.  The TPU kernel's tile-wide one-hot
// matmul has no role here, and neither has a copy of the columns: the
// design is in place, so a step moves only the slots it touches.  The
// hazard that brings is the FAA landing on a slot whose claimed hit has
// not yet read its step-entry freq.  Three short passes in stream order
// keep it out:
//   1. over hits: reset the per-slot scratch (ts_eff, claim) at hit slots
//      and snapshot each hit's step-entry freq into a per-hit scratch;
//   2. over hits and emits: atomicMax of the hit timestamp into
//      ts_eff[slot] and an atomicMin claim of the hit index, so exactly one
//      thread per slot writes in pass 3 (duplicate hits must not read each
//      other's output); and the FAA as a 32-bit atomicAdd on the low word
//      of the int64 freq (little-endian; the value stays in [0, 2^32), so
//      the add wraps as u32 does and is exact in any order).  The FAA may
//      land before or after pass 2's claims: pass 3 reads the snapshot;
//   3. over claimed hits: the last_ts / ext write from the snapshot and
//      the slot's step-entry last_ts and ext, which only this thread
//      writes.
// The scratch columns are reset only at the slots a call touches.  Thread
// 0 of pass 1 adds one to the launch counter (pass 1 runs whenever
// anything does), so a launch replayed from a CUDA graph is counted too.
// f32 arithmetic uses the explicit round-to-nearest intrinsics, so nvcc
// never contracts a multiply-add into an FMA the plain version does not
// do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hmu_init_kernel(const int64_t* __restrict__ hit_slots,
                                int n_hit,
                                const int64_t* __restrict__ freq,
                                unsigned int* __restrict__ ts_eff,
                                int* __restrict__ claim,
                                unsigned int* __restrict__ freq0,
                                unsigned long long* __restrict__ launches) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) atomicAdd(launches, 1ull);
  if (i >= n_hit) return;
  const int64_t s = hit_slots[i];
  if (s < 0) return;
  ts_eff[s] = 0u;
  claim[s] = 0x7fffffff;
  freq0[i] = (unsigned int)freq[s];
}

__global__ void hmu_combine_faa_kernel(
    const int64_t* __restrict__ hit_slots,
    const int64_t* __restrict__ hit_ts, int n_hit,
    const int64_t* __restrict__ emit_slots,
    const int64_t* __restrict__ emit_deltas, int n_emit,
    unsigned int* __restrict__ ts_eff, int* __restrict__ claim,
    int64_t* __restrict__ freq) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_hit) {
    const int64_t s = hit_slots[i];
    if (s >= 0) {
      atomicMax(ts_eff + s, (unsigned int)hit_ts[i]);
      atomicMin(claim + s, i);
    }
  }
  if (i < n_emit) {
    const int64_t s = emit_slots[i];
    if (s >= 0)
      atomicAdd(reinterpret_cast<unsigned int*>(freq + s),
                (unsigned int)emit_deltas[i]);
  }
}

__global__ void hmu_write_kernel(const int64_t* __restrict__ hit_slots,
                                 int n_hit,
                                 const unsigned int* __restrict__ ts_eff,
                                 const int* __restrict__ claim,
                                 const unsigned int* __restrict__ freq0,
                                 int64_t* __restrict__ last_ts,
                                 float* __restrict__ ext) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_hit) return;
  const int64_t s = hit_slots[i];
  if (s < 0 || claim[s] != i) return;
  const unsigned int t = ts_eff[s];
  const unsigned int last = (unsigned int)last_ts[s];
  const unsigned int fr = freq0[i];
  float* e = ext + 4 * s;
  const float e0 = e[0], e1 = e[1], e2 = e[2];
  last_ts[s] = (int64_t)(last > t ? last : t);

  const float clock_f = __uint2float_rn(t);
  const float widx = fmodf(__fadd_rn(__uint2float_rn(fr), 1.0f), 2.0f);
  const float gap = __fsub_rn(clock_f, __uint2float_rn(last));
  // 2^x as XLA lowers jnp.exp2: exp(f32(ln 2) * x).
  const float decay = expf(__fmul_rn(0x1.62e430p-1f, __fmul_rn(-0.05f, gap)));
  e[0] = widx == 0.0f ? clock_f : e0;
  e[1] = widx == 1.0f ? clock_f : e1;
  e[2] = __fadd_rn(1.0f, __fmul_rn(e2, decay));
  e[3] = gap;
}

}  // namespace

extern "C" int hit_metadata_update_launch(
    int64_t* freq, int64_t* last_ts, float* ext, const int64_t* hit_slots,
    const int64_t* hit_ts, int n_hit, const int64_t* emit_slots,
    const int64_t* emit_deltas, int n_emit, unsigned int* ts_eff, int* claim,
    unsigned int* freq0, unsigned long long* launches, void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_hit <= 0 && n_emit <= 0) return (int)cudaGetLastError();
  const int hit_blocks = n_hit > 0 ? (n_hit + threads - 1) / threads : 1;
  hmu_init_kernel<<<hit_blocks, threads, 0, st>>>(hit_slots, n_hit, freq,
                                                  ts_eff, claim, freq0,
                                                  launches);
  const int n2 = n_hit > n_emit ? n_hit : n_emit;
  hmu_combine_faa_kernel<<<(n2 + threads - 1) / threads, threads, 0, st>>>(
      hit_slots, hit_ts, n_hit, emit_slots, emit_deltas, n_emit, ts_eff,
      claim, freq);
  if (n_hit > 0) {
    hmu_write_kernel<<<hit_blocks, threads, 0, st>>>(
        hit_slots, n_hit, ts_eff, claim, freq0, last_ts, ext);
  }
  return (int)cudaGetLastError();
}
