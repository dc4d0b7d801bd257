// Training flash attention backward for Hopper (sm_90a), bf16, at head dims
// above 192 (flash_bwd_sm90.cu takes the rest), up to 512.
//
// Replaces the JAX package's Pallas kernels:
//   flash_bwd_dq_kernel  <- sdbc_tpu/ops/flash_attention_bwd.py  _dq_kernel  (via flash_bwd),
//   flash_bwd_dkv_kernel <- sdbc_tpu/ops/flash_attention_bwd.py  _dkv_kernel (via flash_bwd),
//                           head dims above 192 only
// (the forward at head dims above 256 is flash_fwd_wide_sm90.cu's).
//
// Math (as the TPU kernels): qs = scale*q and kl = log2e*k, each folded in
// fp32 and rounded ONCE to bf16 (on the way into shared memory, exactly as
// the plain version rounds them); lse2 = lse*log2e; delta = rowsum(dO*O)
// comes from the caller in fp32; p = exp2(qs.kl^T - lse2), ds0 =
// bf16(p*(dO.V^T - delta)); dq = (scale/log2e) * sum ds0.kl, dk = sum
// ds0^T.qs, dv = sum bf16(p)^T.dO.  Rows past Sq and columns past Sk
// contribute nothing (bounds masks set their p to 0).
//
// Head dims above 256 (the VAE's single 512-wide head): a 64 x 512 fp32
// accumulator does not fit a block's registers, so each block owns one
// 256-wide slice of the gradients' columns (DO = 256 of DP = 512; two
// blocks per q or KV tile), and streams its non-resident operands in
// 256-wide column chunks, so that shared memory holds them at DP = 512.
//
// What bounds them on the H100: per score element the dq kernel costs 6*D
// tensor FLOPs and one exp2, the dkv kernel 8*D and one exp2; at these
// head dims the tensor cores (~989 TFLOP/s of bf16) set the bound.
//
// Design (FlashAttention-2's register layout with the backward products):
// blocks of 4 warps, each warp owning 16 rows of a 64-row tile;
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with S and P in registers,
// whose accumulator layout is the next product's A layout.  The head dim
// is zero-padded to a multiple of 16 in shared memory; ragged sequence ends
// are bounds-masked.  Products that contract over the sequence (ds0.kl in
// dq, p^T.dO and ds0^T.qs in dkv) read their B operand from a transposed
// copy of the tile in shared memory.  The dq kernel walks KV tiles for one
// q tile; the dkv kernel walks q tiles for one KV tile and keeps dk and dv
// in registers: the two partition the work as the JAX grids do, so no
// atomics are needed.  wgmma, TMA and overlapping loads with math are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // kv rows per tile
constexpr int NWARPS = 4;   // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr int BKP = BK + 8; // padded row of a transposed (DP x 64) tile
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <int DP>
__host__ __device__ constexpr int ld() { return DP + 8; }  // padded row tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16) at rows [0, 16), cols [k0, k0 + 16) of a row-major
// tile of row stride `ld`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int k0, int g, int t) {
  const bf16* p = base + g * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// Rows [r0, r0 + 64) of a (rows x D) bf16 matrix into a (64 x DP) shared
// tile of row stride ld<DP>(), zero-filling rows >= n and columns >= D; with
// SCALE each value is multiplied in fp32 and rounded once back to bf16.
template <int DP, bool SCALE>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int r0, int n,
                                          int D, float scale) {
  constexpr int CH = DP / 8;
  const int dch = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c8 = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c8 < dch) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride
                                            + c8 * 8);
      if (SCALE) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld<DP>() + c8 * 8) = val;
  }
}

// Shared (64 x DP) row tile -> shared (DP x 64) transposed tile (row stride
// BKP).  The caller synchronises before and after.
template <int DP>
__device__ __forceinline__ void transpose_tile(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < 64 * DP; i += NTHREADS) {
    const int d = i / 64, r = i % 64;
    dst[d * BKP + r] = src[r * ld<DP>() + d];
  }
}

// S (16 x 64) (+)= A_w (16 x W, from column 0 of a row tile of row stride
// `lda`) . B^T, with B's 64 rows from a (64 x W) row tile: the shape of
// every score-like product here, or one W-wide column chunk of it
// (`accumulate` false zeroes S first).
template <int W>
__device__ __forceinline__ void rows_by_chunk(float (&s)[BK / 8][4],
                                              const bf16* aw, int lda,
                                              const bf16* b, bool accumulate,
                                              int g, int t) {
  constexpr int LD = ld<W>();
  constexpr int KS = W / 16;
  if (!accumulate) {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    load_a(a, aw, lda, ks * 16, g, t);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const bf16* bp = b + (nt * 8 + g) * LD + ks * 16 + 2 * t;
      mma_bf16(s[nt], a, lds32(bp), lds32(bp + 8));
    }
  }
}

// acc (16 x DP) += P (16 x 64, A fragments in registers) . X (64 x DP),
// X read from its transposed (DP x 64) copy.
template <int DP>
__device__ __forceinline__ void p_by_tile(float (&acc)[DP / 8][4],
                                          const uint32_t (&pf)[BK / 16][4],
                                          const bf16* xt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const bf16* bp = xt + (nt * 8 + g) * BKP + kk * 16 + 2 * t;
      mma_bf16(acc[nt], pf[kk], lds32(bp), lds32(bp + 8));
    }
  }
}

// Stores a (16 x DP) fp32 accumulator times `mul` as bf16 rows r0 and
// r0 + 8 (of this lane) where < n, columns < D.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int n, int D, int t,
                                           float mul0, float mul1) {
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int col = nt * 8 + 2 * t;  // D is even: a pair never straddles it
    if (col < D) {
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(dst + (long long)r0 * row_stride + col) =
            pack_bf16(acc[nt][0] * mul0, acc[nt][1] * mul0);
      if (r0 + 8 < n)
        *reinterpret_cast<uint32_t*>(dst + (long long)(r0 + 8) * row_stride
                                     + col) =
            pack_bf16(acc[nt][2] * mul1, acc[nt][3] * mul1);
    }
  }
}

struct Strides {  // (batch, head, seq) strides in elements
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// K6a: dq for one 64-row q tile, streaming K/V tiles.  DO: output columns
// per block (DP, or a 256-wide slice of DP = 512, two blocks per q
// tile).  K and V tiles arrive in DO-wide
// column chunks through one buffer (a whole 64 x 512 K and V tile beside
// the resident q and dO would not fit shared memory); the K chunk of the
// block's own slice is transposed for ds0.kl.

template <int DP, int DO>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Sq, int Sk, int D, Strides qs_, Strides ks_,
                    Strides vs_, Strides dos_, Strides dqs_, float scale,
                    float dq_mul) {
  constexpr int LD = ld<DP>();
  constexpr int NT = DO / 8;
  constexpr int NS = DP / DO;  // output slices per q tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // qs = bf16(scale * q)
  bf16* dOs = Qs + BQ * LD;
  bf16* Cs = dOs + BQ * LD;   // one DO-wide chunk of kl = bf16(log2e * k) or V
  bf16* Kt = Cs + BK * ld<DO>();  // this block's slice of kl, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = blockIdx.x % NS, q0 = (blockIdx.x / NS) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d0 = slice * DO, Dv = min(D - d0, DO);
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  load_rows<DP, true>(Qs, q + b * qs_.b + h * qs_.h, qs_.s, q0, Sq, D, scale);
  load_rows<DP, false>(dOs, dout + b * dos_.b + h * dos_.h, dos_.s, q0, Sq, D,
                       1.f);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const long long bh = ((long long)b * H + h) * Sq;
  const float lse0 = row0 < Sq ? lse[bh + row0] * LOG2E : 0.f;
  const float lse1 = row1 < Sq ? lse[bh + row1] * LOG2E : 0.f;
  const float dl0 = row0 < Sq ? delta[bh + row0] : 0.f;
  const float dl1 = row1 < Sq ? delta[bh + row1] : 0.f;
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (Sk + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      __syncthreads();  // every warp is done with Cs (and Kt)
      load_rows<DO, true>(Cs, kb + c * DO, ks_.s, k0, Sk, D - c * DO, LOG2E);
      __syncthreads();
      if (c == slice) transpose_tile<DO>(Kt, Cs);
      rows_by_chunk<DO>(s, Qw + c * DO, LD, Cs, c > 0, g, t);
    }
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      __syncthreads();
      load_rows<DO, false>(Cs, vb + c * DO, vs_.s, k0, Sk, D - c * DO, 1.f);
      __syncthreads();  // (also: Kt complete)
      rows_by_chunk<DO>(dp, dOw + c * DO, LD, Cs, c > 0, g, t);
    }
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * t;
      const bool in0 = col < Sk, in1 = col + 1 < Sk;
      const float p0 = in0 ? exp2f(s[nt][0] - lse0) : 0.f;
      const float p1 = in1 ? exp2f(s[nt][1] - lse0) : 0.f;
      const float p2 = in0 ? exp2f(s[nt][2] - lse1) : 0.f;
      const float p3 = in1 ? exp2f(s[nt][3] - lse1) : 0.f;
      dsf[nt >> 1][(nt & 1) * 2 + 0] =
          pack_bf16(p0 * (dp[nt][0] - dl0), p1 * (dp[nt][1] - dl0));
      dsf[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(p2 * (dp[nt][2] - dl1), p3 * (dp[nt][3] - dl1));
    }
    p_by_tile<DO>(acc, dsf, Kt, g, t);
  }
  store_rows<DO>(dq + b * dqs_.b + h * dqs_.h + d0, dqs_.s, acc, row0, Sq, Dv,
                 t, dq_mul, dq_mul);
}

// ---------------------------------------------------------------------------
// K6b: dk, dv for one 64-row KV tile, streaming q / dO tiles.  Each warp
// owns 16 kv rows and computes the transposed products s^T = kl.qs^T and
// dp^T = V.dO^T, so p^T and ds0^T land in A-fragment layout directly.  DO
// as in K6a: kl and V stay resident at the full DP, q and dO tiles arrive
// in DO-wide column chunks through one buffer; the q chunk of the block's
// slice is transposed for dk, then the dO chunk of that slice (streamed
// last, so it is still in the buffer) for dv, through one transposed tile.

template <int DP, int DO>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, int D,
                     Strides qs_, Strides ks_, Strides vs_, Strides dos_,
                     Strides dks_, Strides dvs_, float scale) {
  constexpr int LD = ld<DP>();
  constexpr int NT = DO / 8;
  constexpr int NS = DP / DO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // kl = bf16(log2e * k)
  bf16* Vs = Ks + BK * LD;
  bf16* Cs = Vs + BK * LD;  // one DO-wide chunk of qs = bf16(scale * q) or dO
  bf16* Tt = Cs + BQ * ld<DO>();  // the slice's qs, then dO, transposed
  float* lse2s = reinterpret_cast<float*>(Tt + DO * BKP);
  float* dls = lse2s + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = blockIdx.x % NS, k0 = (blockIdx.x / NS) * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d0 = slice * DO, Dv = min(D - d0, DO);
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* dob = dout + b * dos_.b + h * dos_.h;
  const long long bh = ((long long)b * H + h) * Sq;

  load_rows<DP, true>(Ks, k + b * ks_.b + h * ks_.h, ks_.s, k0, Sk, D, LOG2E);
  load_rows<DP, false>(Vs, v + b * vs_.b + h * vs_.h, vs_.s, k0, Sk, D, 1.f);
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int ntiles = (Sq + BQ - 1) / BQ;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int r0 = tile * BQ;
    // p^T (16 kv x 64 q) = kl . qs^T, chunk by chunk
    float p[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      __syncthreads();  // every warp is done with Cs, Tt and the row stats
      load_rows<DO, true>(Cs, qb + c * DO, qs_.s, r0, Sq, D - c * DO, scale);
      if (c == 0) {
        for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
          const bool in = r0 + i < Sq;
          lse2s[i] = in ? lse[bh + r0 + i] * LOG2E : 0.f;
          dls[i] = in ? delta[bh + r0 + i] : 0.f;
        }
      }
      __syncthreads();
      if (c == slice) transpose_tile<DO>(Tt, Cs);
      rows_by_chunk<DO>(p, Kw + c * DO, LD, Cs, c > 0, g, t);
    }
    // dp^T = V . dO^T, the slice's chunk last
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = (slice + 1 + i) % NS;
      __syncthreads();
      load_rows<DO, false>(Cs, dob + c * DO, dos_.s, r0, Sq, D - c * DO, 1.f);
      __syncthreads();  // (also: Tt complete)
      rows_by_chunk<DO>(dp, Vw + c * DO, LD, Cs, i > 0, g, t);
    }
    // p^T = exp2(s^T - lse2[q]), q columns past Sq -> 0;
    // ds0^T = bf16(p^T * (dp^T - delta[q]))
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const bool in0 = r0 + c < Sq, in1 = r0 + c + 1 < Sq;
      const float p0 = in0 ? exp2f(p[nt][0] - lse2s[c]) : 0.f;
      const float p1 = in1 ? exp2f(p[nt][1] - lse2s[c + 1]) : 0.f;
      const float p2 = in0 ? exp2f(p[nt][2] - lse2s[c]) : 0.f;
      const float p3 = in1 ? exp2f(p[nt][3] - lse2s[c + 1]) : 0.f;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      dsf[nt >> 1][(nt & 1) * 2 + 0] =
          pack_bf16(p0 * (dp[nt][0] - dls[c]), p1 * (dp[nt][1] - dls[c + 1]));
      dsf[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(p2 * (dp[nt][2] - dls[c]), p3 * (dp[nt][3] - dls[c + 1]));
    }
    p_by_tile<DO>(dka, dsf, Tt, g, t);  // dk += ds0^T . qs
    __syncthreads();  // every warp is done with the qs slice
    transpose_tile<DO>(Tt, Cs);
    __syncthreads();
    p_by_tile<DO>(dva, pf, Tt, g, t);  // dv += bf16(p)^T . dO
  }
  const int row0 = k0 + warp * 16 + g;
  store_rows<DO>(dk + b * dks_.b + h * dks_.h + d0, dks_.s, dka, row0, Sk, Dv,
                 t, 1.f, 1.f);
  store_rows<DO>(dv + b * dvs_.b + h * dvs_.h + d0, dvs_.s, dva, row0, Sk, Dv,
                 t, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launchers

template <int DP, int DO>
constexpr size_t dq_smem() {
  return (2 * (size_t)BQ * ld<DP>() + (size_t)BK * ld<DO>()
          + (size_t)DO * BKP) * sizeof(bf16);
}
template <int DP, int DO>
constexpr size_t dkv_smem() {
  return (2 * (size_t)BK * ld<DP>() + (size_t)BQ * ld<DO>()
          + (size_t)DO * BKP) * sizeof(bf16) + 2 * BQ * sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Strides strides3(const long long* p) { return Strides{p[0], p[1], p[2]}; }

template <int DP, int DO>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      const long long* s, float scale, float dq_mul,
                      cudaStream_t stream) {
  const size_t smem = dq_smem<DP, DO>();
  cudaError_t err = set_smem(flash_bwd_dq_kernel<DP, DO>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ * (DP / DO), H, B);
  flash_bwd_dq_kernel<DP, DO><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), H, Sq, Sk, D, strides3(s), strides3(s + 3), strides3(s + 6),
      strides3(s + 9), strides3(s + 12), scale, dq_mul);
  return cudaGetLastError();
}

template <int DP, int DO>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                       const long long* s, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<DP, DO>();
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<DP, DO>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK * (DP / DO), H, B);
  flash_bwd_dkv_kernel<DP, DO><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, D, strides3(s),
      strides3(s + 3), strides3(s + 6), strides3(s + 9), strides3(s + 12), strides3(s + 15), scale);
  return cudaGetLastError();
}

// What the kernels take: D a multiple of 8 in (192, 512].
bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 192 || D > 512
         || D % 8 != 0;
}

}  // namespace

// The backward for head dims in (192, 512] (up to 192 it is
// flash_bwd_sm90.cu's kernels; above 256 each block owns one 256-wide
// slice of the gradients' columns); `lse` is the natural-log LSE and
// `delta` rowsum(dO*O), both contiguous (B, H, Sq) fp32: q and k are
// folded and the LSE scaled on the way into shared memory.
extern "C" int sdbc_flash_bwd_dq_wide(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, const long long* st, float scale,
                                      float dq_mul, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D))
    return (int)cudaErrorInvalidValue;
#define SDBC_DQ(DP, DO)                                                     \
  (int)launch_dq<DP, DO>(q, k, v, dout, static_cast<const float*>(lse),     \
                         static_cast<const float*>(delta), dq, B, H, Sq, Sk, \
                         D, st, scale, dq_mul,                               \
                         static_cast<cudaStream_t>(stream))
  return D <= 256 ? SDBC_DQ(256, 256) : SDBC_DQ(512, 256);
#undef SDBC_DQ
}

extern "C" int sdbc_flash_bwd_dkv_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D,
                                       const long long* st, float scale,
                                       void* stream) {
  if (bad_shape(B, H, Sq, Sk, D))
    return (int)cudaErrorInvalidValue;
#define SDBC_DKV(DP, DO)                                                     \
  (int)launch_dkv<DP, DO>(q, k, v, dout, static_cast<const float*>(lse),     \
                          static_cast<const float*>(delta), dk, dv, B, H, Sq, \
                          Sk, D, st, scale,                                   \
                          static_cast<cudaStream_t>(stream))
  return D <= 256 ? SDBC_DKV(256, 256) : SDBC_DKV(512, 256);
#undef SDBC_DKV
}
