// Fixed-cap inference flash attention for Hopper (sm_90a), bf16.
//
// Replaces the JAX package's Pallas kernels in sdbc_tpu/ops/flash_attention.py:
//   _fixed_kernel_bshd (projection layout, entry flash_attention_fixed_bshd),
//   _fixed_kernel_raw  (head-major layout, entry flash_attention_fixed) and
//   _fixed_kernel      (padded fallback for sequence lengths no block divides).
// One kernel covers all three: it takes (batch, seq, head) strides, so the
// (B, S, H, D) and (B, H, S, D) layouts differ only in the strides, and it
// masks ragged sequence ends and zero-pads the head dim to a multiple of 16
// in shared memory.
//
// Math (as the TPU kernels): q is prescaled by scale*log2e in fp32 and rounded
// to bf16; s = q.k^T accumulates in fp32; p = exp2(min(s, 60)); l = sum(p) in
// fp32; o = (p -> bf16).v / max(l, 1e-37).  No running max and no rescale:
// the cap keeps this exact fp32 softmax for natural logits up to 60/log2e.
//
// What bounds it on the H100: at the 64^2 level (d = 40) each score costs
// 2*2*40 = 160 tensor FLOPs but one exponential.  The H100 gives ~989 TF/s of
// bf16 tensor math against ~3.7 T exp/s on its special-function units, i.e.
// ~267 tensor FLOPs per exponential, so d = 40 and d = 80 are bound by the
// exponentials and the per-score scalar work around them, while d = 160 is
// tensor-core bound.
//
// Design (the FlashAttention-2 register layout, without its running max):
// one block of 4 warps per (64-row q tile, head, batch); each warp owns 16 q
// rows.  The block walks the KV sequence in 64-row tiles staged in shared
// memory (V transposed on the way in, rows padded by 16 bytes against bank
// conflicts).  S = Q K^T runs on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) and stays in registers; exp2 and the row sums are applied to
// the accumulator registers directly, whose layout is also the A-operand
// layout of the next product, so P goes to bf16 in registers and
// O += P V runs without a trip through shared memory.  The q fragments stay
// in registers across the KV loop up to d = 128.  With no running max there
// is no rescale of O.  Shared memory exceeds 48 KB from d = 112 on, so it is
// dynamic and the limit is raised with cudaFuncSetAttribute.  wgmma, TMA and
// overlapping one tile's loads with the previous tile's math are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // q rows per block
constexpr int BK = 64;      // kv rows per tile
constexpr int NWARPS = 4;   // 16 q rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr int BKP = BK + 8; // padded row of the transposed V tile
constexpr float CAP = 60.f;

template <int DP>
__host__ __device__ constexpr int ld() { return DP + 8; }  // padded Q, K rows

template <int DP>
constexpr size_t smem_bytes() {
  return ((size_t)BQ * ld<DP>() + (size_t)BK * ld<DP>() + (size_t)DP * BKP)
         * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, row-major) at rows [0, 16), cols [k0, k0 + 16) of a
// tile with row stride `ld`: lane (g = lane/4, t = lane%4) holds rows g and
// g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* base,
                                       int ld, int k0, int g, int t) {
  const __nv_bfloat16* p = base + g * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// Copies rows [r0, r0 + 64) of a (rows x D) bf16 matrix into a (64 x DP)
// shared tile of row stride LD, zero-filling rows >= n and columns >= D;
// with SCALE, each value is scaled in fp32 and rounded back to bf16.
template <int DP, bool SCALE>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int r0, int n,
                                          int D, float scale) {
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  const int dch = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c8 = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c8 < dch) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride
                                            + c8 * 8);
      if (SCALE) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld<DP>() + c8 * 8) = val;
  }
}

// V rows [r0, r0 + 64) transposed into Vt[d][kv] (row stride BKP).
template <int DP>
__device__ __forceinline__ void load_vt(__nv_bfloat16* vt,
                                        const __nv_bfloat16* src,
                                        long long row_stride, int r0, int n,
                                        int D) {
  constexpr int CH = DP / 8;
  const int dch = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i % 64, c8 = i / 64;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c8 < dch)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride
                                            + c8 * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c8 * 8 + j) * BKP + r] = e[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_fixed_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Sk, int D,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   long long osb, long long oss, long long osh, float qscale) {
  constexpr int LD = ld<DP>();
  constexpr int KS = DP / 16;       // k16 steps over the head dim
  constexpr int NT = DP / 8;        // n8 tiles of the output
  constexpr bool HOIST = DP <= 128; // q fragments kept in registers
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vt = Ks + BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;

  load_rows<DP, true>(Qs, qb, qss, q0, Sq, D, qscale);
  __syncthreads();
  const __nv_bfloat16* Qw = Qs + warp * 16 * LD;
  uint32_t qf[HOIST ? KS : 1][4];
  if (HOIST) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(qf[HOIST ? ks : 0], Qw, LD, ks * 16, g, t);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // partial row sums of rows g and g + 8

  const int ntiles = (Sk + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<DP, false>(Ks, kb, kss, k0, Sk, D, 1.f);
    load_vt<DP>(Vt, vb, vss, k0, Sk, D);
    __syncthreads();

    // S (16 x 64) = Q_w (16 x DP) . K^T, log2 units, in registers
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        if (HOIST) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[HOIST ? ks : 0][i];
        } else {
          load_a(a, Qw, LD, ks * 16, g, t);
        }
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], a, lds32(kp), lds32(kp + 8));
      }
    }

    // p = exp2(min(s, CAP)), zero past Sk; fp32 row sums; P -> bf16 A
    // fragments of the PV product (the accumulator layout of two adjacent
    // n8 tiles is the A layout of one k16 step)
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * t;
      const bool in0 = col < Sk, in1 = col + 1 < Sk;
      const float p0 = in0 ? exp2f(fminf(s[nt][0], CAP)) : 0.f;
      const float p1 = in1 ? exp2f(fminf(s[nt][1], CAP)) : 0.f;
      const float p2 = in0 ? exp2f(fminf(s[nt][2], CAP)) : 0.f;
      const float p3 = in1 ? exp2f(fminf(s[nt][3], CAP)) : 0.f;
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O (16 x DP) += P (16 x 64) . V (64 x DP), V read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* vp = Vt + (nt * 8 + g) * BKP + kk * 16 + 2 * t;
        mma_bf16(acc[nt], pf[kk], lds32(vp), lds32(vp + 8));
      }
    }
  }

  // full row sums across the 4 lanes that share a row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-37f);
  l1 = fmaxf(l1, 1e-37f);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;  // D is even: a pair never straddles it
    if (col < D) {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * oss + col) =
            pack_bf16(acc[nt][0] / l0, acc[nt][1] / l0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * oss + col) =
            pack_bf16(acc[nt][2] / l1, acc[nt][3] / l1);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Sk, int D, const long long* st,
                   float qscale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fixed_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fixed_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], qscale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o: bf16 with (batch, seq, head) strides in elements and a contiguous
// head dim; D <= 256 and a multiple of 8.  Returns cudaGetLastError() after
// the launch.
extern "C" int sdbc_flash_fixed(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Sq, int Sk, int D,
                                long long qsb, long long qss, long long qsh,
                                long long ksb, long long kss, long long ksh,
                                long long vsb, long long vss, long long vsh,
                                long long osb, long long oss, long long osh,
                                float qscale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 256 || D % 8 != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
#define SDBC_FLASH_CASE(DP) \
  case DP: return (int)launch<DP>(q, k, v, o, B, H, Sq, Sk, D, st, qscale, s);
  switch ((D + 15) / 16 * 16) {
    SDBC_FLASH_CASE(16) SDBC_FLASH_CASE(32) SDBC_FLASH_CASE(48)
    SDBC_FLASH_CASE(64) SDBC_FLASH_CASE(80) SDBC_FLASH_CASE(96)
    SDBC_FLASH_CASE(112) SDBC_FLASH_CASE(128) SDBC_FLASH_CASE(144)
    SDBC_FLASH_CASE(160) SDBC_FLASH_CASE(176) SDBC_FLASH_CASE(192)
    SDBC_FLASH_CASE(208) SDBC_FLASH_CASE(224) SDBC_FLASH_CASE(240)
    SDBC_FLASH_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDBC_FLASH_CASE
}

extern "C" const char* sdbc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
