// Fused GEGLU feed-forward for Hopper (sm_90a), bf16.
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/ops/geglu_ff.py::_kernel
// (wrapper _geglu_ff_rows, entry geglu_ff): the spatial transformer's
//   out = y + (val * gelu_erf(gate)) . W2 + b2,   [val | gate] = LN(y) . W1 + b1
// over rows of width c, with LayerNorm eps from the caller and fp32
// statistics, the up-projection rounded to bf16 before + b1 (a bf16 add),
// val the first 4c columns of W1 and gate the last 4c.  The exact erff is used
// (the TPU kernel's polynomial only stood in for a missing erf lowering).
//
// What bounds it on the H100: 24 * rows * c^2 FLOPs against ~4 * rows * c
// bytes of activations, so it is compute-bound (c = 320: ~1900 FLOP/byte;
// the card's balance point is ~295).  W1 and W2 together are 24 * c^2 bytes,
// 9.8 MB at c = 640, so every row tile re-reads them from the 50 MB L2, not
// from HBM.  Reading weight fragments straight from L2 in every warp made
// the earlier versions latency-bound; here each block copies each weight
// byte into shared memory once, and the tensor-core fragments come from
// there.
//
// Design: one block of 8 warps per tile of BR rows (64 for c <= 320, 32
// above, to fit shared memory).  Prologue: LayerNorm in fp32 (one warp per
// row), affine applied, rounded to bf16 into shared memory.  Loop over
// 64-column chunks j of the 4c hidden:
//   - cp.async copies W2's 64 rows of chunk j into shared memory, and W1's
//     val and gate columns of chunk j in 32-row slabs, double-buffered, so
//     the next slab is in flight while the current one is multiplied;
//   - val_j and gate_j (BR x 64 each) on tensor cores with wmma bf16
//     16x16x16 fragments (fp32 accumulate), staged in shared memory;
//   - + b1 (bf16), GELU gate, a_j rounded to bf16 into shared memory;
//   - out += a_j . W2[j rows, :] into fp32 accumulator fragments that stay
//     in registers for the whole loop (each warp owns one 16-row tile and
//     a contiguous group of output column tiles).
// Epilogue: o = y + (out + b2) in fp32, stored as bf16.  The 4c hidden never
// reaches HBM.  Shared memory is 141 KB at c = 320 and 161 KB at c = 640, so
// it is dynamic and the limit is raised with cudaFuncSetAttribute.  TMA and
// wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BH = 64;    // hidden columns per chunk
constexpr int KS1 = 32;   // W1 rows per staged slab
constexpr int NW = 8;     // warps
constexpr int NTHREADS = NW * 32;
constexpr int W1LD = 2 * BH + 8;  // staged W1 slab row: val | gate (+ pad)
constexpr int HLD = BH + 4;       // fp32 val/gate tile row (+ pad)
constexpr int ALD = BH + 8;       // bf16 a_j tile row (+ pad)

// Tile geometry for a width C: rows per block and the warp split.
template <int C>
struct Geo {
  static constexpr int BR = C <= 320 ? 64 : 32;   // rows per block
  static constexpr int RT = BR / 16;              // 16-row tiles
  static constexpr int CW = NW / RT;              // column groups per tile
  static constexpr int NF = C / 16 / CW;          // output fragments / warp
  static constexpr int XLD = C + 8;               // LN tile / W2 slab row
  static constexpr size_t XN = (size_t)BR * XLD * 2;
  static constexpr size_t W1S = (size_t)2 * KS1 * W1LD * 2;
  static constexpr size_t W2S = (size_t)BH * XLD * 2;
  static constexpr size_t HS = (size_t)2 * BR * HLD * 4;
  static constexpr size_t AS = (size_t)BR * ALD * 2;
  static constexpr size_t SMEM = XN + W1S + W2S + HS + AS;
  static_assert(C % (16 * CW) == 0, "c must split evenly over the warps");
  static_assert(NW * 256 * 4 <= HS, "epilogue staging must fit in Hs");
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int C>
__global__ void __launch_bounds__(NTHREADS)
geglu_ff_kernel(const __nv_bfloat16* __restrict__ y,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2,
                const __nv_bfloat16* __restrict__ b2,
                __nv_bfloat16* __restrict__ out, int rows, float eps) {
  using G = Geo<C>;
  constexpr int BR = G::BR, RT = G::RT, NF = G::NF, XLD = G::XLD;
  constexpr int INNER = 4 * C, WIDE = 8 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xn = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem + G::XN);
  __nv_bfloat16* W2s = reinterpret_cast<__nv_bfloat16*>(smem + G::XN + G::W1S);
  float* Hs = reinterpret_cast<float*>(smem + G::XN + G::W1S + G::W2S);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(
      smem + G::XN + G::W1S + G::W2S + G::HS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BR;

  // LayerNorm (two-pass fp32 statistics), affine, rounded to bf16
  for (int r = warp; r < BR; r += NW) {
    const int row = r0 + r;
    if (row < rows) {
      const __nv_bfloat16* yr = y + (long long)row * C;
      float s = 0.f;
      for (int i = lane; i < C; i += 32) s += __bfloat162float(yr[i]);
      const float mu = warp_sum(s) / C;
      float s2 = 0.f;
      for (int i = lane; i < C; i += 32) {
        const float d = __bfloat162float(yr[i]) - mu;
        s2 += d * d;
      }
      const float rstd = rsqrtf(warp_sum(s2) / C + eps);
      for (int i = lane; i < C; i += 32)
        Xn[r * XLD + i] = __float2bfloat16(
            (__bfloat162float(yr[i]) - mu) * rstd * gamma[i] + beta[i]);
    } else {
      for (int i = lane; i < C; i += 32) Xn[r * XLD + i] = __float2bfloat16(0.f);
    }
  }

  // warp roles: row tile rt; in the up-projection, RT of the 8 (val 0-3,
  // gate 4-7) column tiles of a chunk starting at u0; in the
  // down-projection, output column tiles [cg * NF, cg * NF + NF)
  const int rt = warp % RT, cg = warp / RT, u0 = cg * RT;
  FragC acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  // W1 slab s of chunk j: rows [s*KS1, s*KS1 + KS1), val and gate columns
  auto copy_w1 = [&](int j, int s, int buf) {
    __nv_bfloat16* dst = W1s + buf * KS1 * W1LD;
    for (int i = tid; i < KS1 * 16; i += NTHREADS) {
      const int r = i >> 4, u = (i >> 3) & 1, c8 = i & 7;
      cp_async16(dst + r * W1LD + u * BH + c8 * 8,
                 w1 + (long long)(s * KS1 + r) * WIDE + u * INNER + j * BH
                     + c8 * 8);
    }
  };

  constexpr int NS = C / KS1;
  for (int j = 0; j < INNER / BH; ++j) {
    // every warp is done with the previous chunk's W2 slab and W1 buffers
    __syncthreads();
    for (int i = tid; i < BH * (C / 8); i += NTHREADS) {
      const int r = i / (C / 8), c8 = i % (C / 8);
      cp_async16(W2s + r * XLD + c8 * 8,
                 w2 + (long long)(j * BH + r) * C + c8 * 8);
    }
    cp_async_commit();
    copy_w1(j, 0, 0);
    cp_async_commit();

    FragC h[RT];
#pragma unroll
    for (int n = 0; n < RT; ++n) wmma::fill_fragment(h[n], 0.f);
    for (int s = 0; s < NS; ++s) {
      if (s + 1 < NS) {
        copy_w1(j, s + 1, (s + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* wb = W1s + (s & 1) * KS1 * W1LD;
#pragma unroll
      for (int kk = 0; kk < KS1 / 16; ++kk) {
        FragA a;
        wmma::load_matrix_sync(a, Xn + rt * 16 * XLD + s * KS1 + kk * 16, XLD);
#pragma unroll
        for (int n = 0; n < RT; ++n) {
          const int u = u0 + n;  // column tile: val 0-3, gate 4-7
          FragB b;
          wmma::load_matrix_sync(b, wb + kk * 16 * W1LD + (u >> 2) * BH
                                        + (u & 3) * 16, W1LD);
          wmma::mma_sync(h[n], a, b, h[n]);
        }
      }
      __syncthreads();  // this buffer is refilled two slabs later
    }
#pragma unroll
    for (int n = 0; n < RT; ++n) {
      const int u = u0 + n;
      wmma::store_matrix_sync(Hs + (u >> 2) * BR * HLD + rt * 16 * HLD
                                  + (u & 3) * 16, h[n], HLD,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // a_j = val * gelu_erf(gate): product rounded to bf16, + b1 in bf16
    for (int e = tid; e < BR * BH; e += NTHREADS) {
      const int r = e / BH, cc = e % BH, col = j * BH + cc;
      const float val = round_bf16(round_bf16(Hs[r * HLD + cc])
                                   + __bfloat162float(b1[col]));
      const float gate = round_bf16(round_bf16(Hs[BR * HLD + r * HLD + cc])
                                    + __bfloat162float(b1[INNER + col]));
      As[r * ALD + cc] = __float2bfloat16(
          val * (0.5f * gate * (1.f + erff(gate * 0.7071067811865476f))));
    }
    __syncthreads();

    // out (16 x NF*16 of this warp) += a_j (16 x 64) . W2s (64 x cols)
#pragma unroll
    for (int kk = 0; kk < BH / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, As + rt * 16 * ALD + kk * 16, ALD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, W2s + kk * 16 * XLD + (cg * NF + f) * 16,
                               XLD);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }

  // o = y + (out + b2), fp32, stored as bf16; staged per fragment through
  // this warp's 1 KB slice of Hs (last read before the final chunk's
  // GEGLU barrier)
  float* stage = Hs + warp * 256;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(stage, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = r0 + rt * 16 + (e >> 4);
      const int col = (cg * NF + f) * 16 + (e & 15);
      if (row < rows) {
        const long long g = (long long)row * C + col;
        const float o = stage[e] + __bfloat162float(b2[col]);
        out[g] = __float2bfloat16(__bfloat162float(y[g]) + o);
      }
    }
    __syncwarp();
  }
}

template <int C>
cudaError_t launch(const void* y, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int rows, float eps,
                   cudaStream_t stream) {
  using G = Geo<C>;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ff_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = (rows + G::BR - 1) / G::BR;
  geglu_ff_kernel<C><<<grid, NTHREADS, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      rows, eps);
  return cudaGetLastError();
}

}  // namespace

// y/out (rows, c), w1 (c, 8c), b1 (8c), w2 (4c, c), b2 (c): bf16, contiguous;
// gamma/beta (c): fp32.  c a multiple of 32 up to 320, or of 64 up to 640.
// Returns cudaGetLastError() after the launch.
extern "C" int sdbc_geglu_ff(const void* y, const void* gamma, const void* beta,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int rows, int c,
                             float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
#define SDBC_GEGLU_CASE(C) \
  case C: return (int)launch<C>(y, gamma, beta, w1, b1, w2, b2, out, rows, eps, s);
  switch (c) {
    SDBC_GEGLU_CASE(32) SDBC_GEGLU_CASE(64) SDBC_GEGLU_CASE(96)
    SDBC_GEGLU_CASE(128) SDBC_GEGLU_CASE(160) SDBC_GEGLU_CASE(192)
    SDBC_GEGLU_CASE(224) SDBC_GEGLU_CASE(256) SDBC_GEGLU_CASE(288)
    SDBC_GEGLU_CASE(320) SDBC_GEGLU_CASE(384) SDBC_GEGLU_CASE(448)
    SDBC_GEGLU_CASE(512) SDBC_GEGLU_CASE(576) SDBC_GEGLU_CASE(640)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDBC_GEGLU_CASE
}
