// Flash-attention forward in fp32 for Hopper (sm_90a) at head dims 264-512
// (the VAE's 512-wide single head) on TMA-fed tf32 wgmma, each product
// split in three ("3xTF32"): the fixed cap and the training forward that
// emits the log-sum-exp, for fp32 q/k/v with a head dim that is a multiple
// of 8 in (256, 512] (flash_fwd_tf32_sm90.cu takes the narrower ones).
//
// Replaces, for those calls, the JAX package's Pallas kernels (which take
// any dtype):
//   FIXED = true  <- sdbc_tpu/ops/flash_attention.py _fixed_kernel_bshd,
//                    _fixed_kernel_raw and _fixed_kernel
//   FIXED = false <- sdbc_tpu/ops/flash_attention.py _fwd_kernel
// and, for the same calls, the CUDA-core flash_simt_fwd_kernel of
// flash_simt.cu, which keeps the head dims that are not a multiple of 8.
//
// Math: flash_fwd_tf32_sm90.cu's (flash_simt.cu's fp32 forward with its
// rounding points; each product a.b as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// x_hi = tf32(x), x_lo = tf32(x - x_hi)), with one more rounding: a score
// is the fp32 sum of two partial dot products, S = S_0 + S_1, S_r over the
// head-dim half r.  The sum of two fp32 terms is the same bits in either
// order, so both CTAs of a pair hold the same S, row max, p and l.
//
// What bounds it on the H100: per score 3 x 4*D tensor FLOPs at 495
// TFLOP/s (tf32): at (1,1,4096,512) 0.2083 ms; the FFMA kernel it replaces
// does 4*D FLOPs a score at 67 TFLOP/s (0.5128 ms).  Every 64-row q tile
// streams K and V^T of its head as hi and lo parts (16 bytes a key and
// head-dim column) from the L2: 32 MB a q tile at (4096, 512).
//
// Design (flash_fwd_tf32_sm90.cu's products and pre-pass, a 2-CTA cluster
// splitting the head dim as flash_bwd_wide_sm90.cu does):
// - Q's hi and lo parts for 64 rows at D = 512 are 256 KB, more than a
//   block's 227 KB.  So a cluster of two CTAs owns each 64-row q tile, CTA
//   r the head-dim columns [256 r, 256 r + 256): its Q slice (hi and lo,
//   128 KB), the matching columns of every K tile and rows of every V^T
//   tile, and those 256 output columns (64 + 64 fp32 accumulator
//   registers a thread).  At B*H = 1 the 64 q tiles give 128 CTAs: the
//   split fills the card where 64 blocks would leave half of it idle.
// - Per key tile of BK = 32 keys each CTA computes its partial S_r =
//   Q_r.K_r^T (three wgmma m64n32k8 a k8 step, Q and K from shared
//   memory) and sends it to the peer's shared memory with st.async, which
//   completes bytes on the peer's mbarrier (two exchange buffers, one a
//   tile in turn; a buffer is re-armed right after its tile's wait, and
//   the peer can only write it again once it has this CTA's next partial,
//   sent after the read).  Then S = S_r + S_peer, the mask, the softmax
//   and P's split exactly as flash_fwd_tf32_sm90.cu's, and O_r += P.V_r
//   from registers (flash_fwd_tf32_sm90.cu's permuted V^T: P goes from
//   the S accumulator to the A registers with no shuffle).
// - The streamed tiles go through a ring of NS = 2 slots of 32 KB in
//   "pieces": a piece is half a CTA's columns of one K tile (4 swizzled
//   column blocks of 32 keys, hi and lo) or half its rows of one V^T tile
//   (128 rows of one 32-key column block, hi and lo), in the order K_j's,
//   V_j's, K_(j+1)'s, ...  So the next piece lands while one is read, and
//   a piece is freed as soon as its products end.  Pieces wholly past D
//   (CTA 1 at D <= 384) are neither loaded nor multiplied; column blocks
//   wholly past D are not loaded, and multiply zeros of Q (no branch
//   among a group's products, which ptxas would serialize).
// - One producer warpgroup (a thread of which keeps the TMA loads in
//   flight) and one consumer warpgroup: 256 threads, ptxas's 255
//   registers.
// - Shared memory (bytes): Q_hi, Q_lo 2 x 65536; the ring 2 x 32768; two
//   exchange buffers 2 x 8192 (64 x 32 fp32); barriers; 1024 to align:
//   214,072 of the 232,448.  A third slot would need 245,760.
// - Epilogue: O_r / l from registers, 8 bytes a thread (rows past Sq and
//   columns past D dropped); CTA 0 writes the lse row (training forward).

#include "sm90.cuh"

// flash_fwd_tf32_sm90.cu's split pre-pass (K_hi, K_lo, V^T_hi, V^T_lo)
cudaError_t sdbc_tf32_split_kv(const float* k, const long long* kst,
                               const float* v, const long long* vst, int B,
                               int H, int Sk, int D, float* scratch,
                               cudaStream_t stream);

namespace {

using sm90::ex2;
using sm90::quad_max;
using sm90::quad_sum;
using sm90::tf32_rna;

constexpr int CB = 32;            // fp32 columns of a swizzled column block
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100
constexpr float CAP = 60.f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

constexpr int DS = 256;          // head-dim columns of a CTA
constexpr int HALF = DS / 2;     // columns of a piece
constexpr int BQ = 64;           // q rows of a cluster
constexpr int BK = 32;           // keys a tile
constexpr int NTHREADS = 256;    // consumer warpgroup, producer warpgroup
constexpr int NS = 2;            // ring slots
constexpr int Q_BYTES = BQ * DS * 4;    // Q_hi; Q_lo follows
constexpr int PART = BK * HALF * 4;     // a piece's hi part; lo follows
constexpr int SLOT = 2 * PART;
constexpr int X_BYTES = BQ * BK * 4;    // one S partial
constexpr int SLOT_OFF = 2 * Q_BYTES;
constexpr int X_OFF = SLOT_OFF + NS * SLOT;
constexpr int BAR_OFF = X_OFF + 2 * X_BYTES;
// full_q, full[NS], empty[NS], xfull[2]
constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS + 2) + 1024;
static_assert(SMEM <= SMEM_MAX, "shared memory");
static_assert(Q_BYTES % 1024 == 0 && PART % 1024 == 0 && X_BYTES % 1024 == 0,
              "tiles on 1024-byte boundaries");

__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }

// S (64 x BK) (+)= Q_r.K^T over the 16 k8 steps of piece p: qh/ql the
// Q_hi / Q_lo tiles (BQ rows a column block), kh/kl the piece's K_hi /
// K_lo column blocks (BK rows each).  `first`: the first product of the
// tile overwrites S.  No branch among the products (ptxas would serialize
// them): columns past D hold zeros in Q.
__device__ __forceinline__ void gemm_qk(float (&s)[BK / 2], const uint8_t* qh,
                                        const uint8_t* ql, const uint8_t* kh,
                                        const uint8_t* kl, int p,
                                        bool first) {
#pragma unroll
  for (int ks = 0; ks < HALF / 8; ++ks) {
    const int qo = (4 * p + ks / 4) * BQ * 128 + (ks % 4) * 32;
    const int ko = (ks / 4) * BK * 128 + (ks % 4) * 32;
    const uint64_t ah = sm90::desc_sw128(qh + qo, 16);
    const uint64_t al = sm90::desc_sw128(ql + qo, 16);
    const uint64_t bh = sm90::desc_sw128(kh + ko, 16);
    const uint64_t bl = sm90::desc_sw128(kl + ko, 16);
    sm90::WgmmaTF32SS<BK>::run(s, al, bh, first && ks == 0 ? 0 : 1);
    sm90::WgmmaTF32SS<BK>::run(s, ah, bl, 1);
    sm90::WgmmaTF32SS<BK>::run(s, ah, bh, 1);
  }
}

// O (64 x HALF) += P (64 x BK: ph, P_hi, and pl, P_lo, in the S
// accumulator's places) . V, read from a V^T piece (vh, vl: HALF rows of
// one 32-key column block, keys permuted by pi within each 8).  k8 step kk
// takes S chunk kk: a0 = (g, key 2t) = s[4kk], a1 = (g + 8, key 2t) =
// s[4kk + 2], a2 = (g, key 2t + 1) = s[4kk + 1], a3 = s[4kk + 3].
__device__ __forceinline__ void gemm_pv(float (&o)[HALF / 2],
                                        const uint32_t (&ph)[BK / 2],
                                        const uint32_t (&pl)[BK / 2],
                                        const uint8_t* vh,
                                        const uint8_t* vl) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                            ph[4 * kk + 3]};
    const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1],
                            pl[4 * kk + 3]};
    const uint64_t bh = sm90::desc_sw128(vh + kk * 32, 16);
    const uint64_t bl = sm90::desc_sw128(vl + kk * 32, 16);
    sm90::WgmmaTF32RS<HALF>::run(o, al, bh);
    sm90::WgmmaTF32RS<HALF>::run(o, ah, bl);
    sm90::WgmmaTF32RS<HALF>::run(o, ah, bh);
  }
}

struct Params {
  float* o;  // (B, H, Sq, D) view, contiguous head dim
  long long osb, osh, oss;
  float* lse;  // (B, H, Sq) fp32, the training forward only
  int H, Sq, Sk, D;
  float qscale;
};

template <bool FIXED>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
flash_tf32_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tkh,
                            const __grid_constant__ CUtensorMap tkl,
                            const __grid_constant__ CUtensorMap tvh,
                            const __grid_constant__ CUtensorMap tvl,
                            Params prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + NS;
  uint64_t* xfull = empty + NS;
  auto slot = [&](int i) { return smem + SLOT_OFF + (i % NS) * SLOT; };

  const int rank = (int)sm90::cluster_ctarank();
  const int q0 = (blockIdx.x / 2) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int col0 = rank * DS;
  const int dv = min(prm.D - col0, DS);   // this CTA's head-dim columns
  const int hv = (dv + HALF - 1) / HALF;  // pieces of a K (or V^T) tile
  const int np = 2 * hv;                  // pieces a key tile
  const int ncbq = (dv + CB - 1) / CB;    // Q column blocks
  const int nk = (prm.Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;  // 0: consumer; 1: producer

  if (dv < DS) {
    // CTA 1 below D = 512: the Q column blocks past D, which no TMA load
    // fills, and the ring (whose K column blocks past D no load fills: the
    // products read them against Q's zeros, so they must hold no NaN)
    // start as zeros
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = ncbq * BQ * 8 + threadIdx.x; i < DS / CB * BQ * 8;
         i += NTHREADS) {
      reinterpret_cast<uint4*>(smem)[i] = z;
      reinterpret_cast<uint4*>(smem + Q_BYTES)[i] = z;
    }
    for (int i = threadIdx.x; i < NS * SLOT / 16; i += NTHREADS)
      reinterpret_cast<uint4*>(smem + SLOT_OFF)[i] = z;
    sm90::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);  // one per consumer warp
    }
    sm90::mbar_init(xfull, 1);
    sm90::mbar_init(xfull + 1, 1);
    sm90::fence_barrier_init();
    // the peer's partials of tiles 0 and 1
    sm90::mbar_expect_tx(xfull, X_BYTES);
    sm90::mbar_expect_tx(xfull + 1, X_BYTES);
  }
  // both CTAs' barriers exist before either stores into the other
  sm90::cluster_sync();

  if (wg == 1) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (threadIdx.x == 128) {
      sm90::mbar_expect_tx(full_q, ncbq * BQ * 128);
      for (int c = 0; c < ncbq; ++c)
        sm90::tma_load_4d(smem + c * BQ * 128, &tq, full_q, col0 + c * CB, q0,
                          h, b);
      for (int i = 0; i < np * nk; ++i) {
        const int s = i % NS, j = i / np, p = i % np;
        uint8_t* sl = slot(i);
        sm90::mbar_wait(empty + s, ((i / NS) & 1) ^ 1);
        if (p < hv) {  // K_j, columns [col0 + 128 p, ...)
          const int ncb = (min(dv - HALF * p, HALF) + CB - 1) / CB;
          sm90::mbar_expect_tx(full + s, 2 * ncb * BK * 128);
          for (int c = 0; c < ncb; ++c) {
            const int col = col0 + HALF * p + c * CB;
            sm90::tma_load_4d(sl + c * BK * 128, &tkh, full + s, col, j * BK,
                              h, b);
            sm90::tma_load_4d(sl + PART + c * BK * 128, &tkl, full + s, col,
                              j * BK, h, b);
          }
        } else {  // V^T_j, rows [col0 + 128 (p - hv), ...)
          const int row = col0 + HALF * (p - hv);
          sm90::mbar_expect_tx(full + s, SLOT);
          sm90::tma_load_4d(sl, &tvh, full + s, j * BK, row, h, b);
          sm90::tma_load_4d(sl + PART, &tvl, full + s, j * BK, row, h, b);
        }
      }
    }
    return;
  }

  // ---- consumer
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  uint8_t* qh = smem;
  uint8_t* ql = smem + Q_BYTES;
  const uint8_t* xs = smem + X_OFF;
  const uint32_t peer_x = sm90::peer_addr(xs, rank ^ 1);
  const uint32_t peer_bar0 = sm90::peer_addr(xfull, rank ^ 1);

  // Q: prescale by scale*log2e in fp32, split into hi and lo
  sm90::mbar_wait(full_q, 0);
  for (int i = t; i < ncbq * BQ * 8; i += 128) {  // 16-byte chunks
    const int off = (i / 512) * BQ * 128 + ((i / 8) % 64) * 128 + (i % 8) * 16;
    float4* ph4 = reinterpret_cast<float4*>(qh + off);
    float4 x = *ph4, lo;
    float* e = reinterpret_cast<float*>(&x);
    float* el = reinterpret_cast<float*>(&lo);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xq = e[k] * prm.qscale;
      const uint32_t hi = tf32_rna(xq);
      e[k] = f32(hi);
      el[k] = f32(tf32_rna(xq - f32(hi)));
    }
    *ph4 = x;
    *reinterpret_cast<float4*>(ql + off) = lo;
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, 128);

  float o0[HALF / 2], o1[HALF / 2];  // output columns [0, 128), [128, 256)
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) o0[i] = o1[i] = 0.f;
  float s[BK / 2];      // S, then P
  uint32_t ph[BK / 2], pl[BK / 2];  // P_hi, P_lo
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums
  const bool ragged = prm.Sk % BK != 0;
  auto release = [&](int i) {
    if (lane == 0) sm90::mbar_arrive(empty + i % NS);
  };
  auto wait_full = [&](int i) {
    sm90::mbar_wait(full + i % NS, (i / NS) & 1);
  };

  for (int j = 0; j < nk; ++j) {
    const int i0 = j * np;
    // S_r = Q_r.K_r^T, one group a piece (S untouched between the groups:
    // the second accumulates on the first's registers in flight)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p < hv) {
        wait_full(i0 + p);
        const uint8_t* kt = slot(i0 + p);
        sm90::wgmma_fence();
        gemm_qk(s, qh, ql, kt, kt + PART, p, p == 0);
        sm90::wgmma_commit();
      }
    }
    if (hv == 2) {
      sm90::wgmma_wait<1>();
      release(i0);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    release(i0 + hv - 1);

    // S = S_r + S_peer: thread t's 16 values as the 16-byte chunks t,
    // t + 128, t + 256, t + 384 of the exchange buffer (every thread of
    // either CTA holds the same places of its accumulator)
    const int xb = j & 1;
    const uint32_t pbar = peer_bar0 + 8 * xb;
#pragma unroll
    for (int k = 0; k < BK / 8; ++k)
      sm90::st_async_v4(peer_x + xb * X_BYTES + (k * 128 + t) * 16, pbar,
                        s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
    sm90::mbar_wait_cluster(xfull + xb, (j >> 1) & 1);
    if (t == 0 && j + 2 < nk)
      sm90::mbar_expect_tx(xfull + xb, X_BYTES);  // tile j + 2's partial
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          xs + xb * X_BYTES + (k * 128 + t) * 16);
      s[4 * k] += v.x;
      s[4 * k + 1] += v.y;
      s[4 * k + 2] += v.z;
      s[4 * k + 3] += v.w;
    }

    // the softmax of S_j in place
    if (ragged && j == nk - 1) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int col = j * BK + n * 8 + 2 * qd;
        if (col >= prm.Sk) s[4 * n] = s[4 * n + 2] = NEG_INF;
        if (col + 1 >= prm.Sk) s[4 * n + 1] = s[4 * n + 3] = NEG_INF;
      }
    }
    if constexpr (FIXED) {
      // masked keys hold -1e30: exp2 gives p = 0
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = ex2(fminf(s[i], CAP));
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        l0 += s[4 * n] + s[4 * n + 1];
        l1 += s[4 * n + 2] + s[4 * n + 3];
      }
    } else {
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[4 * n] = ex2(s[4 * n] - m0);
        s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
        s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
        s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
        r0 += s[4 * n] + s[4 * n + 1];
        r1 += s[4 * n + 2] + s[4 * n + 3];
      }
      l0 = l0 * a0 + r0;
      l1 = l1 * a1 + r1;
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n) {
        o0[4 * n] *= a0;
        o0[4 * n + 1] *= a0;
        o0[4 * n + 2] *= a1;
        o0[4 * n + 3] *= a1;
        o1[4 * n] *= a0;
        o1[4 * n + 1] *= a0;
        o1[4 * n + 2] *= a1;
        o1[4 * n + 3] *= a1;
      }
    }
    // P = P_hi + P_lo, both ready before the products' fence
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      ph[i] = tf32_rna(s[i]);
      pl[i] = tf32_rna(s[i] - f32(ph[i]));
    }

    // O_r += P_j.V_r,j, one group a piece
    sm90::fence_regs(o0);
    sm90::fence_regs(o1);
    wait_full(i0 + hv);
    const uint8_t* vt = slot(i0 + hv);
    sm90::wgmma_fence();
    gemm_pv(o0, ph, pl, vt, vt + PART);
    sm90::wgmma_commit();
    if (hv == 2) {
      wait_full(i0 + 3);
      const uint8_t* vt1 = slot(i0 + 3);
      sm90::wgmma_fence();
      gemm_pv(o1, ph, pl, vt1, vt1 + PART);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      release(i0 + hv);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o0);
    sm90::fence_regs(o1);
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    release(i0 + np - 1);
  }

  // epilogue: O_r / l from registers, rows g and g + 8 of this warp's 16
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / (FIXED ? fmaxf(l0, 1e-37f) : l0);
  const float i1 = 1.f / (FIXED ? fmaxf(l1, 1e-37f) : l1);
  const int row = q0 + warp * 16 + g;
  float* ob = prm.o + b * prm.osb + h * prm.osh;
  auto put = [&](const float (&o)[HALF / 2], int c0) {
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n) {
      const int col = c0 + n * 8 + 2 * qd;  // D % 8 == 0: col + 1 < D too
      if (col < prm.D) {
        if (row < prm.Sq)
          *reinterpret_cast<float2*>(ob + row * prm.oss + col) =
              make_float2(o[4 * n] * i0, o[4 * n + 1] * i0);
        if (row + 8 < prm.Sq)
          *reinterpret_cast<float2*>(ob + (row + 8) * prm.oss + col) =
              make_float2(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
    }
  };
  put(o0, col0);
  if (hv == 2) put(o1, col0 + HALF);
  if (!FIXED && rank == 0 && qd == 0) {
    float* lb = prm.lse + ((long long)b * prm.H + h) * prm.Sq;
    if (row < prm.Sq) lb[row] = m0 * LN2 + logf(l0);
    if (row + 8 < prm.Sq) lb[row + 8] = m1 * LN2 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

template <bool FIXED>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, float* scratch, int B, int H, int Sq, int Sk,
                   int D, const long long* st, float qscale,
                   cudaStream_t stream) {
  const int Skp = (Sk + 7) / 8 * 8;
  const long long n = (long long)B * H * Skp * D;
  float* khi = scratch;
  float* klo = khi + n;
  float* vhi = klo + n;
  float* vlo = vhi + n;
  const cuuint64_t cB = B, cH = H, cD = D;
  const cuuint64_t qdims[4] = {cD, (cuuint64_t)Sq, cH, cB};
  const long long qst[3] = {st[2], st[1], st[0]};
  const cuuint64_t kdims[4] = {cD, (cuuint64_t)Sk, cH, cB};
  const long long kst[3] = {D, (long long)Sk * D, (long long)H * Sk * D};
  const cuuint64_t vdims[4] = {(cuuint64_t)Skp, cD, cH, cB};
  const long long vst[3] = {Skp, (long long)D * Skp, (long long)H * D * Skp};
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  if (!sm90::make_map_f32(&tq, q, qdims, qst, BQ)
      || !sm90::make_map_f32(&tkh, khi, kdims, kst, BK)
      || !sm90::make_map_f32(&tkl, klo, kdims, kst, BK)
      || !sm90::make_map_f32(&tvh, vhi, vdims, vst, HALF)
      || !sm90::make_map_f32(&tvl, vlo, vdims, vst, HALF))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_tf32_wide_sm90_kernel<FIXED>, SMEM,
                                     raised);
  if (err != cudaSuccess) return err;
  err = sdbc_tf32_split_kv(k, st + 4, v, st + 8, B, H, Sk, D, scratch, stream);
  if (err != cudaSuccess) return err;
  const Params prm{o, st[12], st[13], st[14], lse, H, Sq, Sk, D, qscale};
  dim3 grid(2 * ((Sq + BQ - 1) / BQ), H, B);
  flash_tf32_wide_sm90_kernel<FIXED>
      <<<grid, NTHREADS, SMEM, stream>>>(tq, tkh, tkl, tvh, tvl, prm);
  return cudaGetLastError();
}

}  // namespace

// K1-K3 (fixed = 1) and K5 (fixed = 0) in fp32 at head dims 264-512: the
// arguments of sdbc_flash_tf32_sm90 (flash_fwd_tf32_sm90.cu), D a multiple
// of 8 in (256, 512]: q, k, v, o (B, H, S, D) fp32 views, `st` holding
// each one's (batch, head, seq, dim) strides in elements in that order; q:
// a contiguous head dim, the other strides multiples of 4, 16-byte aligned
// (TMA); k, v: any strides; o: a contiguous head dim, even strides, 8-byte
// aligned.  `lse` a contiguous (B, H, Sq) fp32 output (fixed = 0);
// `scratch` a 16-byte aligned fp32 buffer of 4 B H Skp D floats (Skp = Sk
// rounded up to 8) that the split pre-pass fills.  Two launches (the
// pre-pass, the attention kernel: clusters of two CTAs); returns
// cudaGetLastError() after them.
extern "C" int sdbc_flash_tf32_wide_sm90(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         void* scratch, int fixed, int B,
                                         int H, int Sq, int Sk, int D,
                                         const long long* st, float qscale,
                                         void* stream) {
  const bool bad_q = st[3] != 1 || (st[0] | st[1] | st[2]) % 4
                     || reinterpret_cast<uintptr_t>(q) % 16;
  const bool bad_o = st[15] != 1 || (st[12] | st[13] | st[14]) % 2
                     || reinterpret_cast<uintptr_t>(o) % 8;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 256 || D > 512
      || D % 8 || B > 65535 || H > 65535 || bad_q || bad_o
      || scratch == nullptr
      || reinterpret_cast<uintptr_t>(scratch) % 16
      || (!fixed && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fixed ? launch<true>(qf, kf, vf, of, lf, sf, B, H, Sq, Sk, D,
                                    st, qscale, s)
                     : launch<false>(qf, kf, vf, of, lf, sf, B, H, Sq, Sk, D,
                                     st, qscale, s));
}
