// Fused GEGLU feed-forward in fp32 for Hopper (sm_90a) on TMA-fed tf32
// wgmma, each product split in three ("3xTF32"), for fp32 rows of the
// widths the bf16 kernel (geglu_ff_sm90.cu) takes: c a multiple of 32 up to
// 320 or of 64 up to 640 (SD-1.5's 320 and 640).
//
// Replaces, for those rows, the JAX package's Pallas kernel
// sdbc_tpu/ops/geglu_ff.py::_kernel (wrapper _geglu_ff_rows), which takes
// any dtype, and the CUDA-core geglu_ff_simt.cu, which keeps the other
// widths:
//   out = y + (val * gelu_erf(gate)) . W2 + b2,  [val | gate] = LN(y) . W1 + b1
// with the rounding points of sdbc_tpu_torch/ops/geglu_ff.py::geglu_ff_ref
// (every rounding to the dtype is exact in fp32): LayerNorm with fp32
// statistics (eps from the caller), the up-projection in fp32 + b1, the
// GEGLU with the exact erff, the down-projection in fp32 + b2, the residual
// added last.  Each product a.b of fp32 operands is a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi with x_hi = tf32(x), x_lo = tf32(x - x_hi) (cvt.rna), summed in
// the fp32 accumulator (~2^-21 of |a|.|b| lost, as in
// flash_fwd_tf32_sm90.cu).  An up-projection entry is the fp32 sum of two
// (four) partial dot products over quarters of the row, added in one fixed
// order by every warpgroup that uses it.
//
// What bounds it on the H100: 24 c^2 FLOPs a row, three tf32 products each
// at 495 TFLOP/s: 0.488 ms at (32768, 320) and at (8192, 640) (the FFMA
// bound, 67 TFLOP/s, 1.2019 ms).  A 64-row tile reads both weights as hi
// and lo parts (96 c^2 bytes) from the L2: 5 GB a call at either shape.
//
// Design (geglu_ff_sm90.cu's, with what fp32 forces):
// - tf32 wgmma reads shared-memory operands K-major only, and W1 (c, 8c)
//   and W2 (4c, c) are MN-major for their products.  A split pre-pass
//   (split_ff_kernel, every call: a LoRA bank rewrites weights in place)
//   writes W1^T (8c, c) and W2^T (c, 4c) as hi and lo parts into a
//   torch.empty scratch of 24 c^2 floats.  Within each group of 8 hidden
//   columns W2^T holds hidden pi(p) = (p % 4) * 2 + p / 4 at position p:
//   the up-projection's accumulator holds hidden columns 2t and 2t + 1 of
//   each 8 (t = lane % 4) where the tf32 A fragment takes t and t + 4, so
//   a goes from the accumulator to the A registers with no shuffle.
// - Hi and lo parts of a resident LayerNorm tile would be 2 x 80 KB at
//   c = 320 (64 rows) and 2 x 160 KB at 640.  The tile stays fp32 (80 KB)
//   and each A fragment of the up-projection is split in registers
//   (A-from-registers wgmma).  Above c = 320 even the fp32 tile (160 KB)
//   leaves too little room for the weights, so a cluster of two CTAs owns
//   each 64-row tile, CTA r the columns [320 r, 320 r + 320): its half of
//   the LayerNorm-ed tile (the statistics from whole rows, read by both)
//   and its 320 output columns.  Template CL: the cluster size, 1 (c <= 320,
//   padded to 320) or 2 (c <= 640, padded to 640).
// - 256 threads: two warpgroups and no producer (a third warpgroup makes
//   ptxas budget 168 registers a thread).  Warpgroup w of CTA r owns the
//   columns [320 r + 160 w, ... + 160) of the (padded) row twice over: its
//   k range of the up-projection and its 160 output columns (80 fp32
//   accumulator registers a thread).
// - The hidden 4c columns go in chunks of 16.  For chunk j each warpgroup
//   computes the partial [val | gate] (64 x 32, one wgmma m64n32k8 a k8
//   step, three a step) over its 160 k columns from its ring of W1^T
//   slabs (32 rows x 32 k, hi and lo, 8 KB).  Thread t takes its A
//   fragments of a slab's four k8 steps from the tile's columns 8 t ..
//   8 t + 7 (two 16-byte loads a row; a column order sigma that the
//   pre-pass gives W1^T's k too), where the A layout's columns t and
//   t + 4 of each step would cost eight 4-byte loads.  It posts the
//   partial into the exchange buffers (64 x 32 fp32 a partial, two
//   buffers in turn): at CL 1 with plain stores and a barrier of the
//   CTA's 256 threads, at CL 2 with st.async into both CTAs' buffers,
//   completing bytes on an mbarrier.  Every warpgroup then sums the 2 CL
//   partials in one order ((P0 + P1) + (P2 + P3)), adds b1, takes the
//   GEGLU of its 64 x 16 a_j and splits it into A fragments, and adds
//   a_j . W2^T_j over its 160 output columns (three wgmma m64n160k8 a k8
//   step, W2^T from a 64-byte-swizzled buffer, 20 KB).
// - Each warpgroup's thread 0 refills its own ring slot as soon as the
//   products reading it have completed (wgmma_wait of the warpgroup), and
//   its W2^T buffer after each down-projection, so the next chunk's W2^T
//   lands during its up-projection.  k slabs and output columns wholly past
//   c are neither loaded nor multiplied.
// - Shared memory (bytes): the fp32 tile 64 x 320 x 4 = 81,920; exchange 2
//   x 2 CL x 8,192; per warpgroup NS1 W1^T slabs of 8,192 and one W2^T
//   buffer of 20,480; NS1 = 4 (CL 1) or 2 (CL 2): 221,184 + barriers.
// - Epilogue: y + (out + b2) in fp32 from registers, 8 bytes a thread, rows
//   past `rows` and columns past c dropped.

#include "sm90.cuh"

namespace {

using sm90::tf32_rna;

constexpr int NTHREADS = 256;  // two warpgroups
constexpr int SMEM_MAX = 232448;
constexpr int BR = 64;      // rows a tile
constexpr int WC = 160;     // k columns and output columns of a warpgroup
constexpr int CC = 2 * WC;  // columns of a CTA
constexpr int HC = 16;      // hidden columns a chunk
constexpr int KS = 32;      // k columns of a W1^T slab (a 128-byte row)
constexpr int NSL = WC / KS;  // slabs a chunk
constexpr int XN_BYTES = BR * CC * 4;
constexpr int W1_PART = 2 * HC * KS * 4;  // a slab's hi part; lo follows
constexpr int W1_SLAB = 2 * W1_PART;
constexpr int W2_PART = WC * HC * 4;      // W2^T's hi part; lo follows
constexpr int W2_BUF = 2 * W2_PART;
constexpr int X_BYTES = BR * 2 * HC * 4;  // one [val | gate] partial
constexpr int BAR_BYTES = 256;

template <int CL>
struct Geo {
  static_assert(CL == 1 || CL == 2, "cluster of one or two CTAs");
  static constexpr int CP = CC * CL;  // the padded row width
  static constexpr int XB = 2 * CL * X_BYTES;  // an exchange buffer
  static constexpr int FIXED = XN_BYTES + 2 * XB + 2 * W2_BUF;
  static constexpr int NS1_FIT = (SMEM_MAX - 1024 - BAR_BYTES - FIXED)
                                 / (2 * W1_SLAB);
  static constexpr int NS1 = NS1_FIT < 4 ? NS1_FIT : 4;  // W1^T ring
  static constexpr int X_OFF = XN_BYTES;
  static constexpr int W2_OFF = X_OFF + 2 * XB;
  static constexpr int W1_OFF = W2_OFF + 2 * W2_BUF;
  static constexpr int BAR_OFF = W1_OFF + 2 * NS1 * W1_SLAB;
  // full1[2][NS1], full2[2], xfull[2]
  static constexpr int SMEM = BAR_OFF + BAR_BYTES + 1024;
  static_assert(NS1 >= 2, "the W1^T ring needs two slabs");
  static_assert(8 * (2 * NS1 + 4) <= BAR_BYTES, "barriers");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(XN_BYTES % 1024 == 0 && XB % 1024 == 0 && W2_BUF % 1024 == 0
                    && W1_SLAB % 1024 == 0 && W1_PART % 1024 == 0
                    && W2_PART % 512 == 0,
                "tiles on 1024-byte boundaries (512: the 64-byte swizzle)");
};

struct Params {
  const float* y;
  const float* gamma;
  const float* beta;
  const float* b1;
  const float* b2;
  float* out;
  int rows, c;
  float eps;
};

__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Byte offset of (row, col) in the fp32 tile: 32-column (128-byte) blocks
// of BR rows, 128-byte swizzle (the 16-byte chunk k of row r at k ^ r % 8).
__device__ __forceinline__ int xn_at(int row, int col) {
  return (col / 32) * BR * 128 + row * 128
         + ((((col % 32) >> 2) ^ row) & 7) * 16 + (col % 4) * 4;
}

template <int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTHREADS, 1)
geglu_ff_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tw1h,
                          const __grid_constant__ CUtensorMap tw1l,
                          const __grid_constant__ CUtensorMap tw2h,
                          const __grid_constant__ CUtensorMap tw2l,
                          Params prm) {
  using G = Geo<CL>;
  constexpr int NS1 = G::NS1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* xfull = bars + 2 * NS1 + 2;

  const int rank = CL == 1 ? 0 : (int)sm90::cluster_ctarank();
  const int r0 = (blockIdx.x / CL) * BR;
  const int c = prm.c, inner = 4 * c;
  const int nch = inner / HC;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int base = rank * CC + wg * WC;  // this warpgroup's columns
  // k slabs (and output columns) of this warpgroup inside the row
  const int nsl = min(max((c - base + KS - 1) / KS, 0), NSL);
  uint64_t* full1 = bars + wg * NS1;
  uint64_t* full2 = bars + 2 * NS1 + wg;
  uint8_t* w1s = smem + G::W1_OFF + wg * NS1 * W1_SLAB;
  uint8_t* w2s = smem + G::W2_OFF + wg * W2_BUF;

  // TMA loads of this warpgroup: W1^T slab use u (chunk u / nsl, slab
  // u % nsl): val rows [16 j, 16 j + 16) and gate rows [4c + 16 j, ...) of
  // its k columns; W2^T chunk j: its 160 output rows of hidden [16 j, ...)
  auto issue_w1 = [&](int u) {
    if (u >= nch * nsl) return;
    const int j = u / nsl, s = u % nsl, st = u % NS1;
    uint8_t* dst = w1s + st * W1_SLAB;
    const int k = base + s * KS;
    sm90::mbar_expect_tx(full1 + st, W1_SLAB);
    sm90::tma_load_2d(dst, &tw1h, full1 + st, k, j * HC);
    sm90::tma_load_2d(dst + W1_PART / 2, &tw1h, full1 + st, k, inner + j * HC);
    sm90::tma_load_2d(dst + W1_PART, &tw1l, full1 + st, k, j * HC);
    sm90::tma_load_2d(dst + W1_PART + W1_PART / 2, &tw1l, full1 + st, k,
                      inner + j * HC);
  };
  auto issue_w2 = [&](int j) {
    if (j >= nch || nsl == 0) return;
    sm90::mbar_expect_tx(full2, W2_BUF);
    sm90::tma_load_2d(w2s, &tw2h, full2, j * HC, base);
    sm90::tma_load_2d(w2s + W2_PART, &tw2l, full2, j * HC, base);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * NS1 + 2; ++i) sm90::mbar_init(bars + i, 1);
    sm90::mbar_init(xfull, 1);
    sm90::mbar_init(xfull + 1, 1);
    sm90::fence_barrier_init();
    // the partials of chunks 0 and 1
    sm90::mbar_expect_tx(xfull, G::XB);
    sm90::mbar_expect_tx(xfull + 1, G::XB);
  }
  // every CTA's barriers exist before any stores into another's
  if constexpr (CL == 2)
    sm90::cluster_sync();
  else
    __syncthreads();
  if (t == 0) {
    sm90::prefetch_tmap(&tw1h);
    sm90::prefetch_tmap(&tw2h);
    for (int u = 0; u < NS1; ++u) issue_w1(u);
    issue_w2(0);
  }

  // LayerNorm of whole rows (a warp a row, statistics in fp32) into this
  // CTA's columns of the fp32 tile; columns past c and rows past `rows`
  // hold zeros
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    constexpr int NF = (G::CP / 4 + 31) / 32;  // float4s a lane
    const int nvalid = c / 4;
    for (int rr = 0; rr < BR / 8; ++rr) {
      const int r = warp * (BR / 8) + rr, row = r0 + r;
      const bool live = row < prm.rows;
      float4 v[NF];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int f = lane + 32 * i;
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && f < nvalid)
          v[i] = __ldg(reinterpret_cast<const float4*>(
                           prm.y + (long long)row * c) + f);
        sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      }
      const float mu = __fdiv_rn(warp_sum(sum), (float)c);
      float s2 = 0.f;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        if (lane + 32 * i < nvalid) {
          const float d0 = v[i].x - mu, d1 = v[i].y - mu;
          const float d2 = v[i].z - mu, d3 = v[i].w - mu;
          s2 += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
      }
      const float rstd = rsqrtf(__fdiv_rn(warp_sum(s2), (float)c) + prm.eps);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int f = lane + 32 * i, lc = 4 * f - rank * CC;
        if (f >= G::CP / 4 || lc < 0 || lc >= CC) continue;
        float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && f < nvalid) {
          const float4 gm =
              __ldg(reinterpret_cast<const float4*>(prm.gamma) + f);
          const float4 bt =
              __ldg(reinterpret_cast<const float4*>(prm.beta) + f);
          n.x = __fadd_rn(__fmul_rn(__fmul_rn(v[i].x - mu, rstd), gm.x), bt.x);
          n.y = __fadd_rn(__fmul_rn(__fmul_rn(v[i].y - mu, rstd), gm.y), bt.y);
          n.z = __fadd_rn(__fmul_rn(__fmul_rn(v[i].z - mu, rstd), gm.z), bt.z);
          n.w = __fadd_rn(__fmul_rn(__fmul_rn(v[i].w - mu, rstd), gm.w), bt.w);
        }
        *reinterpret_cast<float4*>(smem + xn_at(r, lc)) = n;
      }
    }
  }
  __syncthreads();

  // ---- the chunks: warpgroup wg
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const uint8_t* xs = smem + G::X_OFF;
  const int part = 2 * rank + wg;  // this warpgroup's partial
  float out[WC / 2];
#pragma unroll
  for (int i = 0; i < WC / 2; ++i) out[i] = 0.f;
  float h[HC];  // [val | gate]: the partial, then the sum
  // this thread's A-fragment bytes in a column block of the tile: rows
  // g and g + 8 (+ 1024) of its warp's 16, the 16-byte chunks 2 t and
  // 2 t + 1 (columns 8 t .. 8 t + 7) under the swizzle
  const int ra0 = (warp * 16 + g) * 128 + ((2 * qd) ^ g) * 16;
  const int ra1 = (warp * 16 + g) * 128 + ((2 * qd + 1) ^ g) * 16;

  for (int j = 0; j < nch; ++j) {
    // the partial [val | gate] over this warpgroup's k columns
#pragma unroll
    for (int i = 0; i < HC; ++i) h[i] = 0.f;
    for (int s = 0; s < nsl; ++s) {
      const int u = j * nsl + s, st = u % NS1;
      // A fragments of the slab's four k8 steps: rows g and g + 8 of this
      // warp's 16, the tile's columns 8 t .. 8 t + 7 of the slab (two
      // 16-byte loads a row; W1^T's k order sigma matches), split into hi
      // and lo
      const uint8_t* xa = smem + (wg * NSL + s) * BR * 128;
      const float4 x0 = *reinterpret_cast<const float4*>(xa + ra0);
      const float4 x1 = *reinterpret_cast<const float4*>(xa + ra1);
      const float4 y0 = *reinterpret_cast<const float4*>(xa + ra0 + 1024);
      const float4 y1 = *reinterpret_cast<const float4*>(xa + ra1 + 1024);
      const float e[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float f[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float x[4] = {e[2 * kk], f[2 * kk], e[2 * kk + 1],
                            f[2 * kk + 1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[kk][q] = tf32_rna(x[q]);
          al[kk][q] = tf32_rna(x[q] - f32(ah[kk][q]));
        }
      }
      sm90::mbar_wait(full1 + st, (u / NS1) & 1);
      const uint8_t* wb = w1s + st * W1_SLAB;
      sm90::fence_regs(h);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bh = sm90::desc_sw128(wb + kk * 32, 16);
        const uint64_t bl = sm90::desc_sw128(wb + W1_PART + kk * 32, 16);
        sm90::WgmmaTF32RS<2 * HC>::run(h, al[kk], bh);
        sm90::WgmmaTF32RS<2 * HC>::run(h, ah[kk], bl);
        sm90::WgmmaTF32RS<2 * HC>::run(h, ah[kk], bh);
      }
      sm90::wgmma_commit();
      sm90::fence_regs(h);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(h);
      if (t == 0) issue_w1(u + NS1);  // the slot is read: refill it
    }

    // post the partial to every CTA of the cluster: thread t's 16 values
    // as the 16-byte chunks t, t + 128, t + 256, t + 384 of its place
    const int xb = j & 1;
    if constexpr (CL == 1) {
      float4* dst = reinterpret_cast<float4*>(smem + G::X_OFF + xb * G::XB
                                              + part * X_BYTES);
#pragma unroll
      for (int k = 0; k < HC / 4; ++k)
        dst[k * 128 + t] = make_float4(h[4 * k], h[4 * k + 1], h[4 * k + 2],
                                       h[4 * k + 3]);
      sm90::bar_sync(1, NTHREADS);
    } else {
#pragma unroll
      for (int d = 0; d < CL; ++d) {
        const uint32_t dst = sm90::peer_addr(
            xs + xb * G::XB + part * X_BYTES, d);
        const uint32_t bar = sm90::peer_addr(xfull + xb, d);
#pragma unroll
        for (int k = 0; k < HC / 4; ++k)
          sm90::st_async_v4(dst + (k * 128 + t) * 16, bar, h[4 * k],
                            h[4 * k + 1], h[4 * k + 2], h[4 * k + 3]);
      }
      sm90::mbar_wait_cluster(xfull + xb, (j >> 1) & 1);
      if (threadIdx.x == 0 && j + 2 < nch)
        sm90::mbar_expect_tx(xfull + xb, G::XB);  // chunk j + 2's partials
    }
    if (nsl == 0) continue;  // no output columns here
    // [val | gate] = (P0 + P1) (+ (P2 + P3)), the same order everywhere
#pragma unroll
    for (int k = 0; k < HC / 4; ++k) {
      const uint8_t* at = xs + xb * G::XB + (k * 128 + t) * 16;
      const float4 p0 = *reinterpret_cast<const float4*>(at);
      const float4 p1 = *reinterpret_cast<const float4*>(at + X_BYTES);
      float4 sm = make_float4(p0.x + p1.x, p0.y + p1.y, p0.z + p1.z,
                              p0.w + p1.w);
      if constexpr (CL == 2) {
        const float4 p2 = *reinterpret_cast<const float4*>(at + 2 * X_BYTES);
        const float4 p3 = *reinterpret_cast<const float4*>(at + 3 * X_BYTES);
        sm = make_float4(sm.x + (p2.x + p3.x), sm.y + (p2.y + p3.y),
                         sm.z + (p2.z + p3.z), sm.w + (p2.w + p3.w));
      }
      h[4 * k] = sm.x;
      h[4 * k + 1] = sm.y;
      h[4 * k + 2] = sm.z;
      h[4 * k + 3] = sm.w;
    }

    // + b1, GEGLU: val element i (hidden 16 j + 8 n + 2 t + e % 2 of row g
    // or g + 8) pairs with gate element i + 8; a_j replaces val in h[0..7]
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = j * HC + n * 8 + 2 * qd;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(prm.b1 + col));
      const float2 bg = __ldg(
          reinterpret_cast<const float2*>(prm.b1 + inner + col));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float v = h[i] + ((e & 1) ? bv.y : bv.x);
        const float gt = h[8 + i] + ((e & 1) ? bg.y : bg.x);
        h[i] = v * ((0.5f * gt) * (1.f + erff(gt * 0.7071067811865476f)));
      }
    }
    // a_j -> hi and lo A fragments: k8 step kk takes a0 = (g, hidden 2t) =
    // h[4kk], a1 = (g + 8, 2t) = h[4kk + 2], a2 = (g, 2t + 1) = h[4kk + 1],
    // a3 = h[4kk + 3] (W2^T's positions permuted by pi)
    uint32_t fh[2][4], fl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float x[4] = {h[4 * kk], h[4 * kk + 2], h[4 * kk + 1],
                          h[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fh[kk][e] = tf32_rna(x[e]);
        fl[kk][e] = tf32_rna(x[e] - f32(fh[kk][e]));
      }
    }
    // out += a_j . W2^T_j over this warpgroup's 160 output columns
    sm90::mbar_wait(full2, j & 1);
    sm90::fence_regs(out);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t bh = sm90::desc_sw64(w2s + kk * 32, 16);
      const uint64_t bl = sm90::desc_sw64(w2s + W2_PART + kk * 32, 16);
      sm90::WgmmaTF32RS<WC>::run(out, fl[kk], bh);
      sm90::WgmmaTF32RS<WC>::run(out, fh[kk], bl);
      sm90::WgmmaTF32RS<WC>::run(out, fh[kk], bh);
    }
    sm90::wgmma_commit();
    sm90::fence_regs(out);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(out);
    if (t == 0) issue_w2(j + 1);  // the buffer is read: the next chunk's
  }

  // epilogue: y + (out + b2) in fp32, rows g and g + 8 of this warp's 16
  if (nsl > 0) {
    const int row = r0 + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < WC / 8; ++n) {
      const int col = base + n * 8 + 2 * qd;  // c % 32 == 0: col + 1 < c too
      if (col >= c) continue;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(prm.b2 + col));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = row + 8 * hh;
        if (rr >= prm.rows) continue;
        const long long at = (long long)rr * c + col;
        const float2 yy = __ldg(reinterpret_cast<const float2*>(prm.y + at));
        *reinterpret_cast<float2*>(prm.out + at) =
            make_float2(yy.x + (out[4 * n + 2 * hh] + bb.x),
                        yy.y + (out[4 * n + 2 * hh + 1] + bb.y));
      }
    }
  }
}

// The split pre-pass: one block a 32 x 32 tile of W1 (the first
// (8c / 32)(c / 32) blocks) or of W2.  W1^T (8c, c) and W2^T (c, 4c) as hi
// and lo parts; W2^T's hidden position p of each group of 8 holds hidden
// pi(p) = (p % 4) * 2 + p / 4 of the group; W1^T's k position p = 8 kk + t
// + 4 h of each 32 (k8 step kk, A-fragment column t + 4 h) holds k
// sigma(p) = 8 t + 2 kk + h, the column that thread t loads for it.
__global__ void __launch_bounds__(256)
split_ff_kernel(const float* w1, const float* w2, int c, float* w1h,
                float* w1l, float* w2h, float* w2l) {
  __shared__ float tile[32][33];
  const int n1 = (8 * c / 32) * (c / 32);
  const bool first = (int)blockIdx.x < n1;
  const int id = first ? blockIdx.x : blockIdx.x - n1;
  // W1: rows k (c), columns hidden (8c); W2: rows hidden (4c), columns out
  const int ncol = first ? 8 * c : c;
  const float* src = first ? w1 : w2;
  const int tr = id / (ncol / 32), tc = id % (ncol / 32);
  for (int i = threadIdx.x; i < 32 * 32; i += 256) {
    const int r = i / 32, cc = i % 32;
    tile[r][cc] = __ldg(src + (long long)(tr * 32 + r) * ncol + tc * 32 + cc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * 32; i += 256) {
    const int r = i / 32, p = i % 32;  // transposed row r, position p
    float x;
    long long at;
    if (first) {  // W1^T[hidden][k at position p: sigma(p)]
      x = tile[8 * (p % 4) + 2 * (p / 8) + (p % 8) / 4][r];
      at = (long long)(tc * 32 + r) * c + tr * 32 + p;
    } else {  // W2^T[out][hidden position]
      x = tile[(p & ~7) | ((p & 3) * 2 + ((p >> 2) & 1))][r];
      at = (long long)(tc * 32 + r) * (4 * c) + tr * 32 + p;
    }
    const uint32_t hi = tf32_rna(x);
    (first ? w1h : w2h)[at] = f32(hi);
    (first ? w1l : w2l)[at] = f32(tf32_rna(x - f32(hi)));
  }
}

// ---------------------------------------------------------------------------
// host side

template <int CL>
cudaError_t launch(const Params& prm, const float* w1, const float* w2,
                   float* scratch, cudaStream_t stream) {
  using G = Geo<CL>;
  const int c = prm.c;
  const long long c2 = (long long)c * c;
  float* w1h = scratch;
  float* w1l = w1h + 8 * c2;
  float* w2h = w1l + 8 * c2;
  float* w2l = w2h + 4 * c2;
  const cuuint64_t C = (cuuint64_t)c;
  // W1^T (8c rows of c) in boxes of 32 k by 16 hidden rows, 128-byte
  // swizzle; W2^T (c rows of 4c) in boxes of 16 hidden by 160 output rows,
  // 64-byte swizzle
  const cuuint64_t w1_dims[2] = {C, 8 * C}, w1_str[1] = {C * 4};
  const cuuint32_t w1_box[2] = {KS, HC};
  const cuuint64_t w2_dims[2] = {4 * C, C}, w2_str[1] = {16 * C};
  const cuuint32_t w2_box[2] = {HC, WC};
  CUtensorMap t1h, t1l, t2h, t2l;
  auto map = [&](CUtensorMap* m, const float* p, const cuuint64_t* dims,
                 const cuuint64_t* str, const cuuint32_t* box,
                 CUtensorMapSwizzle sw) {
    return sm90::make_map_nd(m, p, 2, dims, str, box, sw,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  };
  if (!map(&t1h, w1h, w1_dims, w1_str, w1_box, CU_TENSOR_MAP_SWIZZLE_128B)
      || !map(&t1l, w1l, w1_dims, w1_str, w1_box, CU_TENSOR_MAP_SWIZZLE_128B)
      || !map(&t2h, w2h, w2_dims, w2_str, w2_box, CU_TENSOR_MAP_SWIZZLE_64B)
      || !map(&t2l, w2l, w2_dims, w2_str, w2_box, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err =
      sm90::raise_smem(geglu_ff_tf32_sm90_kernel<CL>, G::SMEM, raised);
  if (err != cudaSuccess) return err;
  const int nt = (8 * c / 32) * (c / 32) + (4 * c / 32) * (c / 32);
  split_ff_kernel<<<nt, 256, 0, stream>>>(w1, w2, c, w1h, w1l, w2h, w2l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = CL * ((prm.rows + BR - 1) / BR);
  geglu_ff_tf32_sm90_kernel<CL>
      <<<grid, NTHREADS, G::SMEM, stream>>>(t1h, t1l, t2h, t2l, prm);
  return cudaGetLastError();
}

}  // namespace

// K4 in fp32: y/out (rows, c), w1 (c, 8c), b1 (8c), w2 (4c, c), b2 (c),
// gamma/beta (c): fp32, contiguous, 16-byte aligned; c a multiple of 32 up
// to 320, or of 64 up to 640.  `scratch` a 16-byte aligned fp32 buffer of
// 24 c^2 floats that the split pre-pass fills.  Two launches (the pre-pass,
// the FF kernel: clusters of two CTAs above c = 320); returns
// cudaGetLastError() after them.
extern "C" int sdbc_geglu_ff_tf32(const void* y, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* scratch,
                                  int rows, int c, float eps, void* stream) {
  if (rows <= 0 || c <= 0 || c % 32 || c > 640 || (c > 320 && c % 64)
      || scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const float*>(y),
                   static_cast<const float*>(gamma),
                   static_cast<const float*>(beta),
                   static_cast<const float*>(b1),
                   static_cast<const float*>(b2), static_cast<float*>(out),
                   rows, c, eps};
  auto* w1f = static_cast<const float*>(w1);
  auto* w2f = static_cast<const float*>(w2);
  auto* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(c <= CC ? launch<1>(prm, w1f, w2f, sf, s)
                       : launch<2>(prm, w1f, w2f, sf, s));
}
