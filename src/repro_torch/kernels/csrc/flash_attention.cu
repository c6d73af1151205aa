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
// the kernel with no copy and no transpose.  The last dimension has
// stride 1.  Offsets are 64-bit.  The output is a fresh contiguous
// [B, T, H, D] tensor.
//
// Bound on the H100: tensor-core operations.  The causal product is
// 0.5 * 4 * B*H*T^2*D flops (8.8e12 at yi-9b's B=1, H=32, T=32768,
// D=128: 8.9 ms at 989 TFLOP/s bf16 dense), against 4*B*T*H*D*2 bytes of
// q, k, v and o (1.07 GB there: 0.32 ms at 3.35 TB/s).  What the design
// does about it: the scores never leave the chip, and both products run
// on the tensor cores, as mma.sync m16n8k16 bf16 with f32 accumulate.
// It is the simple form: one CTA of 4 warps per (b*h, 64-row query tile),
// each warp owning 16 query rows; the Q tile is staged in shared memory
// once and held as A fragments in registers; the K tile and the V tile
// (transposed, so that its B fragments are 32-bit loads) are staged in
// shared memory in turn with plain loads and __syncthreads(), no
// cp.async or TMA pipeline and no wgmma.  Per-row m and l and the output
// accumulator stay in f32 registers; the probabilities are repacked from
// the score accumulators into A fragments without touching shared
// memory.  Query tiles launch longest first (the diagonal end of the
// sequence).  A ragged last tile (T not a multiple of 64) is masked
// here: rows past T are neither loaded as keys nor written.
//
// f32 inputs (the card's tests) take a second kernel of the same shape
// with plain FMA in f32, since mma.sync has no f32 form that keeps f32
// precision: 2 threads a query row, each holding half of the scores of a
// KV tile and half of the row's output columns.
//
// Thread 0 of block (0, 0) adds one to the launch counter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // query rows a CTA
constexpr int BN = 64;         // keys a KV tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr float NEG = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bf16_kernel(const Params p) {
  constexpr int LDK = D + 8;   // row pitch of Qs and Ks (bf16 elements)
  constexpr int LDV = BN + 8;  // row pitch of Vt
  constexpr int CH = D / 8;    // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDK]
  __nv_bfloat16* Ks = Qs + BM * LDK;                               // [BN][LDK]
  __nv_bfloat16* Vt = Ks + BN * LDK;                               // [D][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n_q = (p.T + BM - 1) / BM;
  const int qt = n_q - 1 - blockIdx.x;
  const int q0 = qt * BM;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(p.launches, 1ull);
  const Bases<__nv_bfloat16> base = bases<__nv_bfloat16, D>(p);

  for (int i = tid; i < BM * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.T)
      val = *reinterpret_cast<const uint4*>(base.q + (q0 + r) * p.q_st + c);
    *reinterpret_cast<uint4*>(Qs + r * LDK + c) = val;
  }
  __syncthreads();

  // A fragments of this warp's 16 query rows, one set per 16 columns of D.
  const int wr = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* r0 = Qs + (wr + g) * LDK + ks * 16 + tg * 2;
    const __nv_bfloat16* r1 = r0 + 8 * LDK;
    qa[ks][0] = ld32(r0);
    qa[ks][1] = ld32(r1);
    qa[ks][2] = ld32(r0 + 8);
    qa[ks][3] = ld32(r1 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // Rows g and g+8 of the warp's 16; m in log2 units (scores * log2 e).
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * 1.4426950408889634f;
  const int row0 = q0 + wr + g, row1 = row0 + 8;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K and V tiles
    for (int i = tid; i < BN * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.T) {
        kv = *reinterpret_cast<const uint4*>(base.k + (k0 + r) * p.k_st + c);
        vv = *reinterpret_cast<const uint4*>(base.v + (k0 + r) * p.v_st + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDK + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 accumulators of 16x8.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LDK + ks * 16 + tg * 2;
        mma_bf16(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale, mask the diagonal tile, running max over the quad's row.
    const bool diag = kt == qt;
    float tm0 = NEG, tm1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (diag) {
          const int key = k0 + nt * 8 + tg * 2 + (e & 1);
          if (key > (e < 2 ? row0 : row1)) x = NEG;
        }
        s[nt][e] = x;
      }
      tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
      tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
    }
    tm0 = fmaxf(tm0, __shfl_xor_sync(FULL, tm0, 1));
    tm0 = fmaxf(tm0, __shfl_xor_sync(FULL, tm0, 2));
    tm1 = fmaxf(tm1, __shfl_xor_sync(FULL, tm1, 1));
    tm1 = fmaxf(tm1, __shfl_xor_sync(FULL, tm1, 2));
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    // l holds this thread's share of the row sum; the quad's shares are
    // added at the end (all four scale by the same correction).
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= c0;
      acc[dt][1] *= c0;
      acc[dt][2] *= c1;
      acc[dt][3] *= c1;
    }

    // O += P V: the score accumulators of key columns 16kk..16kk+15 are
    // the A fragment of that k-step.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = Vt + (dt * 8 + g) * LDV + kk * 16 + tg * 2;
        mma_bf16(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tg * 2;
    if (row0 < p.T)
      *reinterpret_cast<uint32_t*>(base.o + row0 * base.o_st + col) =
          pack_bf16(acc[dt][0] / d0, acc[dt][1] / d0);
    if (row1 < p.T)
      *reinterpret_cast<uint32_t*>(base.o + row1 * base.o_st + col) =
          pack_bf16(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA, 2 threads a query row.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_f32_kernel(const Params p) {
  constexpr int LD = D + 1;    // odd pitch: rows fall in different banks
  constexpr int LDP = BN + 1;
  constexpr int HD = D / 2;    // output columns a thread
  constexpr int HN = BN / 2;   // keys a thread scores
  extern __shared__ float smf[];
  float* Qs = smf;             // [BM][LD]
  float* Ks = Qs + BM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* Ps = Vs + BN * LD;    // [BM][LDP]

  const int tid = threadIdx.x;
  const int r = tid >> 1, hf = tid & 1;
  const int n_q = (p.T + BM - 1) / BM;
  const int qt = n_q - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const int row = q0 + r;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(p.launches, 1ull);
  const Bases<float> base = bases<float, D>(p);

  for (int i = tid; i < BM * D; i += NTHREADS) {
    const int rr = i / D, c = i % D;
    Qs[rr * LD + c] = q0 + rr < p.T ? base.q[(q0 + rr) * p.q_st + c] : 0.f;
  }

  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = NEG, l = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    for (int i = tid; i < BN * D; i += NTHREADS) {
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
    for (int j = 0; j < BN; ++j) {
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
int launch_d(const Params& p, int is_f32, int B, cudaStream_t stream) {
  const dim3 grid((p.T + BM - 1) / BM, B * p.H);
  if (!is_f32) {
    const int smem = (BM * (D + 8) + BN * (D + 8) + D * (BN + 8)) * 2;
    cudaFuncSetAttribute(flash_bf16_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bf16_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  } else {
    const int smem = (BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1)) * 4;
    cudaFuncSetAttribute(flash_f32_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_f32_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  }
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
  if (B <= 0 || T <= 0 || H <= 0 || n_rep <= 0 || H % n_rep != 0 ||
      (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
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
  p.scale = (float)(1.0 / sqrt((double)D));
  p.launches = launches;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_d<32>(p, is_f32, B, st);
    case 64: return launch_d<64>(p, is_f32, B, st);
    case 128: return launch_d<128>(p, is_f32, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
