// Fixed-cap attention with an int8 Q.K^T for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/ops/flash_attention.py
// _int8_kernel (via _flash_fixed_fwd_int8), which nothing dispatches: the
// SageAttention split, int8 scores and a bf16 P.V.  The caller quantizes q
// and k per row, as the JAX wrapper does outside its kernel: absmax over
// the head dim in fp32, s = max(absmax, 1e-8) / 127, round(x / s) half to
// even, int8; scale*log2e is folded into q's row scales.  Here:
//   s_ij = float(qi_i . ki_j) * qs_i * ks_j    (int32 product, log2 units)
//   p_ij = exp2(min(s_ij, 60))                  (no running max: the cap)
//   l_i  = sum_j p_ij in fp32
//   o_i  = sum_j bf16(p_ij) v_j / max(l_i, 1e-37)
// Columns past Sk get p = 0 and rows past Sq are not written (the JAX
// wrapper instead drops a ragged KV tail).
//
// What bounds it on the H100: like the bf16 fixed-cap kernel
// (flash_fwd_sm90.cu), the exponentials.  Per score it costs 2*D int8
// operations (at 1979 TOP/s), 2*D bf16 FLOPs (989 TFLOP/s) and one exp2
// (~3.9 T/s on the special-function units): at D = 40 the exp2 takes ~3x
// the two products together, so int8 halves only the half that does not
// bind.
//
// Design (FlashAttention-2's register layout on mma.sync): one block of 4
// warps per (64-row q tile, head, batch), each warp owning 16 q rows; the
// q fragments of mma.sync.m16n8k32 (s8 x s8 -> s32) stay in registers
// across the KV loop.
// KV tiles of 64 rows: int8 K rows and their scales, and bf16 V transposed,
// in shared memory.  The int8 head dim is zero-padded to a multiple of 32
// (40 -> 64), the bf16 one to a multiple of 16.  The s32 accumulator layout
// of the score product is the A layout of the bf16 m16n8k16 P.V product,
// so P goes to bf16 in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BKP = BK + 8;  // padded row of the transposed V tile
constexpr float CAP = 60.f;

typedef __nv_bfloat16 bf16;

template <int DV>
__host__ __device__ constexpr int ldv() { return DV + 8; }  // V rows (bf16)
template <int DQ>
__host__ __device__ constexpr int ldq() { return DQ + 16; }  // int8 rows (bytes)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of a contiguous int8 (rows x row_bytes) matrix into a
// (64 x DQ) shared tile, zero past n rows and past row_bytes.
template <int DQ>
__device__ __forceinline__ void load_i8(int8_t* dst, const int8_t* src,
                                        int row_bytes, int r0, int n) {
  constexpr int CH = DQ / 16;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c * 16 < row_bytes)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_bytes
                                            + c * 16);
    *reinterpret_cast<uint4*>(dst + r * ldq<DQ>() + c * 16) = val;
  }
}

// Rows [r0, r0 + 64) of a bf16 (rows x D) matrix of row stride `row_stride`
// into a (64 x DV) shared tile, zero past n rows and D columns.
template <int DV>
__device__ __forceinline__ void load_v(bf16* dst, const bf16* src,
                                       long long row_stride, int r0, int n,
                                       int D) {
  constexpr int CH = DV / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c8 = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c8 * 8 < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride
                                            + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * ldv<DV>() + c8 * 8) = val;
  }
}

struct Strides {  // (batch, head, seq) strides in elements
  long long b, h, s;
};

template <int DQ, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_int8_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
                  const int8_t* __restrict__ ki, const float* __restrict__ ksc,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                  int Sq, int Sk, int D, int row_bytes, Strides vs_,
                  Strides os_) {
  constexpr int LQ = ldq<DQ>();
  constexpr int LV = ldv<DV>();
  constexpr int NT = DV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Qs + BQ * LQ;
  bf16* Vs = reinterpret_cast<bf16*>(Ks + BK * LQ);
  bf16* Vt = Vs + BK * LV;
  float* kss = reinterpret_cast<float*>(Vt + DV * BKP);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const int8_t* kb = ki + bh * Sk * row_bytes;
  const float* ksb = ksc + bh * Sk;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  load_i8<DQ>(Qs, qi + bh * Sq * row_bytes, row_bytes, q0, Sq);
  __syncthreads();
  uint32_t qa[DQ / 32][4];  // this warp's A fragments, kept across the loop
  {
    const int8_t* qw = Qs + warp * 16 * LQ;
#pragma unroll
    for (int ks = 0; ks < DQ / 32; ++ks) {
      const int8_t* p = qw + g * LQ + ks * 32 + 4 * t;
      qa[ks][0] = ld32(p);
      qa[ks][1] = ld32(p + 8 * LQ);
      qa[ks][2] = ld32(p + 16);
      qa[ks][3] = ld32(p + 8 * LQ + 16);
    }
  }
  const int row0 = q0 + warp * 16 + g;
  const float qs0 = row0 < Sq ? qsc[bh * Sq + row0] : 0.f;
  const float qs1 = row0 + 8 < Sq ? qsc[bh * Sq + row0 + 8] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  const int ntiles = (Sk + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_i8<DQ>(Ks, kb, row_bytes, k0, Sk);
    load_v<DV>(Vs, vb, vs_.s, k0, Sk, D);
    for (int i = threadIdx.x; i < BK; i += NTHREADS)
      kss[i] = k0 + i < Sk ? ksb[k0 + i] : 0.f;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * DV; i += NTHREADS) {
      const int d = i / BK, r = i % BK;
      Vt[d * BKP + r] = Vs[r * LV + d];
    }

    int si[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
#pragma unroll
    for (int ks = 0; ks < DQ / 32; ++ks) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int8_t* bp = Ks + (nt * 8 + g) * LQ + ks * 32 + 4 * t;
        mma_s8(si[nt], qa[ks], ld32(bp), ld32(bp + 16));
      }
    }
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const bool in0 = k0 + c < Sk, in1 = k0 + c + 1 < Sk;
      const float ks0 = kss[c], ks1 = kss[c + 1];
      const float p0 = in0 ? exp2f(fminf((float)si[nt][0] * qs0 * ks0, CAP)) : 0.f;
      const float p1 = in1 ? exp2f(fminf((float)si[nt][1] * qs0 * ks1, CAP)) : 0.f;
      const float p2 = in0 ? exp2f(fminf((float)si[nt][2] * qs1 * ks0, CAP)) : 0.f;
      const float p3 = in1 ? exp2f(fminf((float)si[nt][3] * qs1 * ks1, CAP)) : 0.f;
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    __syncthreads();  // Vt complete
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* bp = Vt + (nt * 8 + g) * BKP + kk * 16 + 2 * t;
        mma_bf16(acc[nt], pf[kk], ld32(bp), ld32(bp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
  bf16* ob = o + b * os_.b + h * os_.h;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;  // D is even: a pair never straddles it
    if (col < D) {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * os_.s + col) =
            pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * os_.s + col) =
            pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
    }
  }
}

template <int DQ, int DV>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * ldq<DQ>()
         + ((size_t)BK * ldv<DV>() + (size_t)DV * BKP) * sizeof(bf16)
         + BK * sizeof(float);
}

template <int DQ, int DV>
cudaError_t launch(const void* qi, const void* qsc, const void* ki,
                   const void* ksc, const void* v, void* o, int B, int H,
                   int Sq, int Sk, int D, int row_bytes, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<DQ, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_int8_kernel<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_int8_kernel<DQ, DV><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qsc),
      static_cast<const int8_t*>(ki), static_cast<const float*>(ksc),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Sq, Sk, D,
      row_bytes, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]});
  return cudaGetLastError();
}

}  // namespace

// qi, ki: contiguous (B, H, S, row_bytes) int8, the head dim zero-padded to
// row_bytes = D rounded up to a multiple of 32; qsc, ksc: contiguous
// (B, H, S) fp32 row scales (scale*log2e folded into qsc); v, o: bf16
// (B, H, S, D) with (batch, head, seq) strides `st` (v's three, then o's)
// and a contiguous head dim.  D a multiple of 8, at most 256.  Returns
// cudaGetLastError() after the launch.
extern "C" int sdbc_flash_int8(const void* qi, const void* qsc, const void* ki,
                               const void* ksc, const void* v, void* o, int B,
                               int H, int Sq, int Sk, int D, int row_bytes,
                               const long long* st, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 || D % 8
      || row_bytes != (D + 31) / 32 * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDBC_CALL(DQ, DV) \
  return (int)launch<DQ, DV>(qi, qsc, ki, ksc, v, o, B, H, Sq, Sk, D, \
                             row_bytes, st, s)
  if (D <= 16) SDBC_CALL(32, 16);
  if (D <= 32) SDBC_CALL(32, 32);
  if (D <= 48) SDBC_CALL(64, 48);
  if (D <= 64) SDBC_CALL(64, 64);
  if (D <= 80) SDBC_CALL(96, 80);
  if (D <= 96) SDBC_CALL(96, 96);
  if (D <= 128) SDBC_CALL(128, 128);
  if (D <= 160) SDBC_CALL(160, 160);
  SDBC_CALL(256, 256);
#undef SDBC_CALL
}
