// flash_attention: causal softmax attention, forward, on [B, T, H, D].
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:88).  Same function: scale D^-0.5,
// online softmax with the running max, sum and accumulator in f32, masked
// scores at -1e30, output = acc / max(l, 1e-30) in the input dtype, KV
// tiles above the diagonal skipped.  The probabilities enter the P.V
// product in the input dtype, as the TPU kernel's p.astype(v.dtype).
//
// Layout.  q is [B, T, H, D]; k and v are [B, T, Hkv, R, D] with H = Hkv*R,
// each given by its element strides (b, t, kv head, repeat), so the GQA
// view that models/attention.py::repeat_kv makes with expand() (stride 0
// on the repeat axis) and a plain [B, T, H, D] tensor (R = 1) both reach
// the kernel with no copy.  The last dimension has stride 1.  The output
// is a fresh contiguous [B, T, H, D] tensor.  Head dims 32, 64, 128, 256.
//
// Bound on the H100: tensor-core operations.  The causal product is
// 0.5 * 4 * B*H*T^2*D flops (8.8e12 at yi-9b's B=1, H=32, T=32768,
// D=128: 8.9 ms at 989 TFLOP/s bf16 dense), against 4*B*T*H*D*2 bytes of
// q, k, v and o (1.07 GB there: 0.32 ms at 3.35 TB/s).
//
// bf16: the usual Hopper forward, for sm_90a.  A CTA owns BM = 128 query
// rows of one (b, h) and runs three warpgroups:
//   - a producer warpgroup (its registers given up with setmaxnreg), one
//     thread of which issues TMA loads: the Q tile once, then K and V
//     tiles of BN keys into two rings of STAGES stages, each stage of
//     each ring guarded by a "full" mbarrier (the copy's bytes) and an
//     "empty" one (the 256 consumer threads' release);
//   - two consumer warpgroups of 64 query rows each, which compute
//     S = Q K^T with wgmma (both operands K-major from 128B-swizzled
//     shared memory, as TMA wrote them), the online softmax in registers
//     on the wgmma accumulator layout (a row's values in a quad of 4
//     threads; log2-prescaled, one FFMA and one ex2.approx.ftz a score;
//     only tiles that cross the diagonal masked), and O += P V with
//     wgmma, P repacked to bf16 from the S accumulators as the A operand
//     in registers and V read straight from its TMA tile through the
//     descriptor's MN-major (transposed) mode: no transposed copy of V
//     exists.
// A consumer keeps S of tile j in flight beside the P.V product of tile
// j - 1 and runs tile j's softmax while that product runs.  The softmax
// bounds the loop by its instruction issue (PERF.md), so it spends one
// FFMA and one ex2.approx.ftz a score, and the output accumulator is
// rescaled only where a row of the warp raised its running max.
// BN = 128 keys for D <= 128 (Q 32 KB + 2 x (K 32 KB + V 32 KB) at
// D = 128) and 64 for D = 256 (Q 64 KB + 2 x (32 + 32) KB = 192 KB), and
// the O accumulator of D = 256 is 128 f32 registers a thread.  The tensor
// maps, built on the host for each call with cuTensorMapEncodeTiled
// (reached through the runtime's driver entry point, so no -lcuda), cover
// each tensor's storage as (D, T, R, G, B) with its byte strides; the GQA
// expand view maps its storage without the stride-0 axis, and the kernel
// uses kv head h / n_rep.  TMA zero-fills rows past T: keys >= T lie only
// in tiles that cross the diagonal of a live row, whose causal mask
// removes them, and only rows < T are written.  A size-1 axis gets a
// nominal stride.  Query tiles launch longest first across all heads
// (blockIdx.y counts down from the diagonal end).  A warpgroup whose
// rows end before the CTA's last KV tile (D = 256) skips it.
//
// f32 inputs (the card's tests) take a second kernel with plain FMA in
// f32, since wgmma has no f32 form that keeps f32 precision: 2 threads a
// query row, each holding half of the scores of a KV tile and half of the
// row's output columns.
//
// Thread 0 of block (0, 0) adds one to the launch counter.

#include <cuda.h>  // CUtensorMap and the encoder's types; no driver link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised.
// ---------------------------------------------------------------------------

constexpr int BM = 128;        // query rows a CTA: two consumer warpgroups
constexpr int WG = 128;        // threads a warpgroup
constexpr int NTHREADS = 3 * WG;
constexpr int STAGES = 2;      // K and V tiles in flight, each
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int D>
struct Tile {
  static constexpr int BN = D <= 128 ? 128 : 64;  // keys a KV tile
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int SWE = SWB / 2;             // bf16 columns a chunk
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V tile
  // Q, the K ring, the V ring, 1 + 4 * STAGES mbarriers, and the slack
  // that aligns the tiles to the 1024-byte swizzle period.
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES) + 1024;
};

struct TcParams {
  CUtensorMap tq, tk, tv;
  void* o;
  int T, H, n_rep;
  int k_rep, v_rep;  // 1 where the map has the repeat axis (stride != 0)
  float scale;
  unsigned long long* launches;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 5-d tensor map (coordinates innermost first) into shared
// memory, its bytes reported to the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units, 14 bits each), swizzle mode in bits 62-63
// (1 = 128B, 2 = 64B).  The tiles sit on the swizzle period, so the base
// offset (bits 49-51) is 0.
template <int SWB>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t mode = SWB == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator, or from
// reusing the registers of an A operand, across the asynchronous product
// that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Two floats as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S += A B^T, A and B K-major in shared memory: m64n64k16.
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(ScaleD));
}

// S += A B^T, A and B K-major in shared memory: m64n128k16.
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(ScaleD));
}

// O += P V, P (bf16) in registers, V MN-major in shared memory: m64n32k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V, P (bf16) in registers, V MN-major in shared memory: m64n64k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V, P (bf16) in registers, V MN-major in shared memory: m64n128k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V, P (bf16) in registers, V MN-major in shared memory: m64n256k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x as the SFU gives it (one MUFU.EX2; a result below 2^-126 is 0,
// which no bf16 probability or f32 row sum here can tell apart).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The running softmax of one consumer thread's two rows over a tile of
// scores sc (the S accumulator: row0 at e < 2, row1 at e >= 2 of each
// 8-key block).  Masks keys above a row where the tile crosses the
// diagonal, updates the running max m (in log2 units: scores * scale *
// log2 e) and the thread's share of the running sum l, leaves
// 2^(s * scale * log2 e - m) in sc and returns the factors c0, c1 by
// which the output accumulator's rows must be rescaled.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float sl2,
                                               bool diag, int key0, int row0,
                                               int row1, float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& c0, float& c1) {
  float tm0 = NEG, tm1 = NEG;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    if (diag) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nb * 8 + (e & 1) > (e < 2 ? row0 : row1))
          sc[4 * nb + e] = NEG;
    }
    tm0 = fmaxf(tm0, fmaxf(sc[4 * nb], sc[4 * nb + 1]));
    tm1 = fmaxf(tm1, fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
  }
  tm0 = fmaxf(tm0, __shfl_xor_sync(FULL, tm0, 1));
  tm0 = fmaxf(tm0, __shfl_xor_sync(FULL, tm0, 2));
  tm1 = fmaxf(tm1, __shfl_xor_sync(FULL, tm1, 1));
  tm1 = fmaxf(tm1, __shfl_xor_sync(FULL, tm1, 2));
  // The scale is positive, so the max of the scaled scores is the
  // scaled max.
  const float mn0 = fmaxf(m0, tm0 * sl2), mn1 = fmaxf(m1, tm1 * sl2);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    sc[4 * nb] = ex2(fmaf(sc[4 * nb], sl2, -mn0));
    sc[4 * nb + 1] = ex2(fmaf(sc[4 * nb + 1], sl2, -mn0));
    sc[4 * nb + 2] = ex2(fmaf(sc[4 * nb + 2], sl2, -mn1));
    sc[4 * nb + 3] = ex2(fmaf(sc[4 * nb + 3], sl2, -mn1));
    ps0 += sc[4 * nb] + sc[4 * nb + 1];
    ps1 += sc[4 * nb + 2] + sc[4 * nb + 3];
  }
  l0 = l0 * c0 + ps0;
  l1 = l1 * c1 + ps1;
}

// P as bf16 A fragments of the P.V product: the accumulators of keys
// 16kk..16kk+15 are the A operand of its step kk.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bf16_kernel(const __grid_constant__ TcParams p) {
  using TL = Tile<D>;
  constexpr int BN = TL::BN, SWB = TL::SWB, SWE = TL::SWE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + TL::Q_BYTES;  // [STAGES][D / SWE][BN][SWE]
  const uint32_t s_v = s_k + STAGES * TL::KV_BYTES;
  // mbarriers: Q; then, for each stage, K full, V full, K empty, V empty.
  const uint32_t bar_q = s_v + STAGES * TL::KV_BYTES;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest first
  const int q0 = qt * BM;
  const int n_kv = (min(p.T, q0 + BM) + BN - 1) / BN;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(p.launches, 1ull);
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * WG);
      mbar_init(empty_v + 8 * s, 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG) {
    // Producer.  The two branches never meet again, as setmaxnreg needs.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      const int g = h / p.n_rep;
      const int rk = p.k_rep ? h % p.n_rep : 0;
      const int rv = p.v_rep ? h % p.n_rep : 0;
      mbar_expect_tx(bar_q, TL::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / SWE; ++c)
        tma_load(s_q + c * BM * SWB, &p.tq, bar_q, c * SWE, q0, 0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;  // fresh: passes at once
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, TL::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / SWE; ++c)
          tma_load(s_k + s * TL::KV_BYTES + c * BN * SWB, &p.tk, full_k + 8 * s,
                   c * SWE, j * BN, rk, g, b);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, TL::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / SWE; ++c)
          tma_load(s_v + s * TL::KV_BYTES + c * BN * SWB, &p.tv, full_v + 8 * s,
                   c * SWE, j * BN, rv, g, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = tid / WG - 1;               // consumer warpgroup 0 or 1
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const int tg = lane & 3;
    const int qw0 = q0 + cw * 64;              // the warpgroup's first row
    const int row0 = qw0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
    const float sl2 = p.scale * LOG2E;
    const uint32_t q_base = s_q + cw * 64 * SWB;
    // Tiles past n_w hold only keys above this warpgroup's rows.
    const int n_w = (min(p.T, qw0 + 64) + BN - 1) / BN;

    // S = Q K_j^T: 64 rows x BN keys, D / 16 steps of k16, both operands
    // K-major.
    auto issue_s = [&](float (&sc)[BN / 2], int j) {
      const uint32_t k_base = s_k + (j % STAGES) * TL::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / SWE, off = (kk * 16 % SWE) * 2;
        const uint64_t da =
            desc<SWB>(q_base + c * BM * SWB + off, 16, 8 * SWB);
        const uint64_t db =
            desc<SWB>(k_base + c * BN * SWB + off, 16, 8 * SWB);
        if (kk == 0)
          wgmma_ss<0>(sc, da, db);
        else
          wgmma_ss<1>(sc, da, db);
      }
      wgmma_commit();
    };
    // O += P V_j: V as stored ([key][D] in chunks of SWE columns) is the
    // MN-major B operand; a step of 16 keys is 16 rows.
    auto issue_pv = [&](float (&acc)[D / 2], uint32_t (&pa)[BN / 16][4],
                        int j) {
      const uint32_t v_base = s_v + (j % STAGES) * TL::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[kk],
                 desc<SWB>(v_base + kk * 16 * SWB, BN * SWB, 8 * SWB));
      wgmma_commit();
    };
    auto parity = [](int j) { return (uint32_t)((j / STAGES) & 1); };

    float acc[D / 2];  // O: m64nD accumulator
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    // m in log2 units (scores * log2 e); l is this thread's share of the
    // row sum (the quad's shares are added at the end).
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, c0, c1;
    mbar_wait(bar_q, 0);

    // Tile 0, then each tile j's S = Q K_j^T in flight beside the P.V
    // product of tile j - 1, its softmax beside that product.
    mbar_wait(full_k, 0);
    wgmma_fence();
    issue_s(sc, 0);
    wgmma_wait<0>();
    reg_fence(sc);
    mbar_arrive(empty_k);
    online_softmax<BN>(sc, sl2, BN - 1 > qw0, tg * 2, row0, row1, m0, m1, l0,
                       l1, c0, c1);
    pack_p<BN>(sc, pa);
    for (int j = 1; j < n_w; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES, k0 = j * BN;
      mbar_wait(full_k + 8 * s, parity(j));
      reg_fence(acc);
      wgmma_fence();
      issue_s(sc, j);
      mbar_wait(full_v + 8 * sp, parity(j - 1));
      issue_pv(acc, pa, j - 1);
      wgmma_wait<1>();  // S_j is in; P.V of tile j - 1 may still run
      reg_fence(sc);
      mbar_arrive(empty_k + 8 * s);
      online_softmax<BN>(sc, sl2, k0 + BN - 1 > qw0, k0 + tg * 2, row0, row1,
                         m0, m1, l0, l1, c0, c1);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);  // the product read pa until here
      mbar_arrive(empty_v + 8 * sp);
      // Rescale where some row of the warp raised its max (c == 1
      // otherwise, and the product would give the same bits).
      if (!__all_sync(FULL, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
          acc[4 * nb] *= c0;
          acc[4 * nb + 1] *= c0;
          acc[4 * nb + 2] *= c1;
          acc[4 * nb + 3] *= c1;
        }
      }
      pack_p<BN>(sc, pa);
    }
    mbar_wait(full_v + 8 * ((n_w - 1) % STAGES), parity(n_w - 1));
    reg_fence(acc);
    wgmma_fence();
    issue_pv(acc, pa, n_w - 1);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    mbar_arrive(empty_v + 8 * ((n_w - 1) % STAGES));
    // Release the stages of the tiles this warpgroup skips, once loaded
    // (an earlier arrival would count toward the stage's previous use).
    for (int j = n_w; j < n_kv; ++j) {
      mbar_wait(full_k + 8 * (j % STAGES), parity(j));
      mbar_wait(full_v + 8 * (j % STAGES), parity(j));
      mbar_arrive(empty_k + 8 * (j % STAGES));
      mbar_arrive(empty_v + 8 * (j % STAGES));
    }

    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int64_t o_st = (int64_t)p.H * D;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                       (int64_t)b * p.T * o_st + (int64_t)h * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = nb * 8 + tg * 2;
      if (row0 < p.T)
        *reinterpret_cast<uint32_t*>(o + row0 * o_st + col) =
            pack_bf16(acc[4 * nb] / d0, acc[4 * nb + 1] / d0);
      if (row1 < p.T)
        *reinterpret_cast<uint32_t*>(o + row1 * o_st + col) =
            pack_bf16(acc[4 * nb + 2] / d1, acc[4 * nb + 3] / d1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA, 2 threads a query row.
// ---------------------------------------------------------------------------

constexpr int F_BM = 64;         // query rows a CTA
constexpr int F_BN = 64;         // keys a KV tile
constexpr int F_THREADS = 128;   // 4 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, H, n_rep;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sg, k_sr;
  int64_t v_sb, v_st, v_sg, v_sr;
  float scale;
  unsigned long long* launches;
};

template <typename Tp>
struct Bases {
  const Tp* q;
  const Tp* k;
  const Tp* v;
  Tp* o;
  int64_t o_st;
};

template <typename Tp, int D>
__device__ __forceinline__ Bases<Tp> bases(const Params& p) {
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / p.n_rep, r = h % p.n_rep;
  Bases<Tp> out;
  out.q = static_cast<const Tp*>(p.q) + b * p.q_sb + h * p.q_sh;
  out.k = static_cast<const Tp*>(p.k) + b * p.k_sb + g * p.k_sg + r * p.k_sr;
  out.v = static_cast<const Tp*>(p.v) + b * p.v_sb + g * p.v_sg + r * p.v_sr;
  out.o_st = (int64_t)p.H * D;
  out.o = static_cast<Tp*>(p.o) + (int64_t)b * p.T * out.o_st +
          (int64_t)h * D;
  return out;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
    flash_f32_kernel(const Params p) {
  constexpr int LD = D + 1;    // odd pitch: rows fall in different banks
  constexpr int LDP = F_BN + 1;
  constexpr int HD = D / 2;    // output columns a thread
  constexpr int HN = F_BN / 2;   // keys a thread scores
  extern __shared__ float smf[];
  float* Qs = smf;             // [F_BM][LD]
  float* Ks = Qs + F_BM * LD;    // [F_BN][LD]
  float* Vs = Ks + F_BN * LD;    // [F_BN][LD]
  float* Ps = Vs + F_BN * LD;    // [F_BM][LDP]

  const int tid = threadIdx.x;
  const int r = tid >> 1, hf = tid & 1;
  const int n_q = (p.T + F_BM - 1) / F_BM;
  const int qt = n_q - 1 - blockIdx.x;
  const int q0 = qt * F_BM;
  const int row = q0 + r;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(p.launches, 1ull);
  const Bases<float> base = bases<float, D>(p);

  for (int i = tid; i < F_BM * D; i += F_THREADS) {
    const int rr = i / D, c = i % D;
    Qs[rr * LD + c] = q0 + rr < p.T ? base.q[(q0 + rr) * p.q_st + c] : 0.f;
  }

  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = NEG, l = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * F_BN;
    __syncthreads();
    for (int i = tid; i < F_BN * D; i += F_THREADS) {
      const int rr = i / D, c = i % D;
      const bool in = k0 + rr < p.T;
      Ks[rr * LD + c] = in ? base.k[(k0 + rr) * p.k_st + c] : 0.f;
      Vs[rr * LD + c] = in ? base.v[(k0 + rr) * p.v_st + c] : 0.f;
    }
    __syncthreads();

    float s[HN];
#pragma unroll
    for (int j = 0; j < HN; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < HN; ++j)
        s[j] = fmaf(qv, Ks[(hf * HN + j) * LD + d], s[j]);
    }
    float tm = NEG;
#pragma unroll
    for (int j = 0; j < HN; ++j) {
      float x = s[j] * p.scale;
      if (kt == qt && k0 + hf * HN + j > row) x = NEG;
      s[j] = x;
      tm = fmaxf(tm, x);
    }
    tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 1));
    const float mn = fmaxf(m, tm);
    const float corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < HN; ++j) {
      const float e = expf(s[j] - mn);
      ps += e;
      Ps[r * LDP + hf * HN + j] = e;
    }
    l = l * corr + ps;
    __syncwarp();  // the row's two threads share a warp
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= corr;
    for (int j = 0; j < F_BN; ++j) {
      const float pj = Ps[r * LDP + j];
#pragma unroll
      for (int c = 0; c < HD; ++c)
        acc[c] = fmaf(pj, Vs[j * LD + hf * HD + c], acc[c]);
    }
  }

  l += __shfl_xor_sync(FULL, l, 1);
  const float den = fmaxf(l, 1e-30f);
  if (row < p.T) {
#pragma unroll
    for (int c = 0; c < HD; ++c)
      base.o[row * base.o_st + hf * HD + c] = acc[c] / den;
  }
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  if ((int64_t)B * p.H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((p.T + F_BM - 1) / F_BM, B * p.H);
  const int smem = (F_BM * (D + 1) + 2 * F_BN * (D + 1) + F_BM * (F_BN + 1)) * 4;
  cudaFuncSetAttribute(flash_f32_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  flash_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled (CUDA 12.0's signature), reached through the
// runtime's driver entry point so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map over bf16 storage of axes (D, T, R, G, B), innermost first,
// with element strides st, sr, sg, sb; a box is swe columns x rows, in the
// 128B (or, for 32 columns, 64B) swizzle that wgmma reads.  A size-1 axis
// gets a nominal stride (its coordinate is always 0).
bool make_map(CUtensorMap* map, const void* ptr, int D, int T, int R, int G,
              int B, int64_t st, int64_t sr, int64_t sg, int64_t sb, int swe,
              int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)R,
                              (cuuint64_t)G, (cuuint64_t)B};
  const int64_t el[4] = {st, sr, sg, sb};
  int64_t span = D;
  for (int i = 0; i < 4; ++i)
    if (dims[i + 1] > 1 && el[i] * (int64_t)dims[i + 1] > span)
      span = el[i] * (int64_t)dims[i + 1];
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i)
    strides[i] = (cuuint64_t)(dims[i + 1] > 1 ? el[i] : span) * 2;
  const cuuint32_t box[5] = {(cuuint32_t)swe, (cuuint32_t)rows, 1, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swe == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(TcParams& p, const void* q, const void* k, const void* v,
                int B, const int64_t* qs, const int64_t* ks,
                const int64_t* vs, cudaStream_t stream) {
  using TL = Tile<D>;
  const int n_q = (p.T + BM - 1) / BM;
  if (n_q > 65535) return (int)cudaErrorInvalidValue;
  const int G = p.H / p.n_rep;
  // qs: (b, t, h); ks, vs: (b, t, kv head, repeat), in elements.
  if (!make_map(&p.tq, q, D, p.T, 1, p.H, B, qs[1], 0, qs[2], qs[0], TL::SWE,
                BM) ||
      !make_map(&p.tk, k, D, p.T, p.k_rep ? p.n_rep : 1, G, B, ks[1], ks[3],
                ks[2], ks[0], TL::SWE, TL::BN) ||
      !make_map(&p.tv, v, D, p.T, p.v_rep ? p.n_rep : 1, G, B, vs[1], vs[3],
                vs[2], vs[0], TL::SWE, TL::BN))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_bf16_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  flash_bf16_kernel<D><<<dim3(B * p.H, n_q), NTHREADS, TL::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  Strides are in elements.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int is_f32, int B,
    int T, int H, int D, int n_rep, int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sg, int64_t k_sr, int64_t v_sb,
    int64_t v_st, int64_t v_sg, int64_t v_sr, unsigned long long* launches,
    void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || n_rep <= 0 || H % n_rep != 0)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_f32) {
    TcParams p;
    p.o = o;
    p.T = T;
    p.H = H;
    p.n_rep = n_rep;
    p.k_rep = n_rep > 1 && k_sr != 0;
    p.v_rep = n_rep > 1 && v_sr != 0;
    p.scale = scale;
    p.launches = launches;
    const int64_t qs[3] = {q_sb, q_st, q_sh};
    const int64_t ks[4] = {k_sb, k_st, k_sg, k_sr};
    const int64_t vs[4] = {v_sb, v_st, v_sg, v_sr};
    switch (D) {
      case 32: return launch_bf16<32>(p, q, k, v, B, qs, ks, vs, st);
      case 64: return launch_bf16<64>(p, q, k, v, B, qs, ks, vs, st);
      case 128: return launch_bf16<128>(p, q, k, v, B, qs, ks, vs, st);
      case 256: return launch_bf16<256>(p, q, k, v, B, qs, ks, vs, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.T = T;
  p.H = H;
  p.n_rep = n_rep;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sg = k_sg;
  p.k_sr = k_sr;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sg = v_sg;
  p.v_sr = v_sr;
  p.scale = scale;
  p.launches = launches;
  switch (D) {
    case 32: return launch_f32<32>(p, B, st);
    case 64: return launch_f32<64>(p, B, st);
    case 128: return launch_f32<128>(p, B, st);
    case 256: return launch_f32<256>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
