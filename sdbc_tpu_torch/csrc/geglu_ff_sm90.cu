// Fused GEGLU feed-forward for Hopper (sm_90a), bf16, on TMA-fed wgmma.
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/ops/geglu_ff.py::_kernel
// (wrapper _geglu_ff_rows, entry geglu_ff): the spatial transformer's
//   out = y + (val * gelu_erf(gate)) . W2 + b2,   [val | gate] = LN(y) . W1 + b1
// over rows of width c, with the rounding points of
// sdbc_tpu_torch/ops/geglu_ff.py::geglu_ff_ref: LayerNorm with fp32
// statistics (eps from the caller), affine, rounded to bf16; the
// up-projection rounded to bf16, then + b1 as a bf16 add; val the first 4c
// columns of W1 and gate the last 4c; a = bf16(val * 0.5*gate*(1 + erf(gate
// / sqrt 2))) with the exact erff; out = bf16(y + (a . W2 + b2)), summed in
// fp32.  W1 is (c, 8c) and W2 (4c, c), row-major bf16 (the JAX layout).
//
// What bounds it on the H100: 24 * rows * c^2 FLOPs against ~4 * rows * c
// bytes of activations, so it is compute-bound (~1900 FLOP/byte at
// c = 320; the card's balance point is ~295).  But each block re-reads all
// 24 c^2 weight bytes (2.46 MB at c = 320, 9.8 MB at c = 640) from the L2
// for its row tile, so a block's work per L2 byte is its row count: at
// few rows per block the L2, not the tensor cores, sets the pace.
//
// Design (FlashAttention's structure: Xn plays Q, the W1 chunk K, the
// GEGLU the softmax, a_j P, the W2 chunk V and the output O):
// - 256 threads, two consumer warpgroups and no producer: a warp more
//   makes ptxas budget registers for 384 threads (168 a thread; the
//   register file is split over four schedulers), and a consumer needs
//   ~250 at c = 320.
// - c is padded to CP, a multiple of 64; columns past c arrive as TMA zero
//   fill and are masked out of the LayerNorm.  For CP <= 320 a block owns
//   128 rows, each consumer 64 rows and all CP output columns (CP / 2 fp32
//   accumulator registers a thread), so every weight byte read from the L2
//   serves 128 rows.  Above 320 the output does not fit one warpgroup's
//   registers: a block owns 64 rows, the two consumers split the output
//   columns and the hidden columns of each chunk, and exchange a_j through
//   shared memory (SS wgmma for the down-projection), so neither
//   recomputes the other's up-projection.
// - The y tile arrives by TMA into the Xn tile (128-byte swizzle, 64-column
//   blocks); the LayerNorm runs in place with 16-byte accesses, a warp per
//   row, and leaves Xn as the K-major A operand of the up-projection.
// - The hidden 4c columns go in chunks of 32 columns per consumer.  A
//   chunk's 32 val and 32 gate columns of W1 land as two 32-column blocks
//   side by side (64-byte swizzle: a 32-column box under the 128-byte
//   swizzle would take 128-byte rows), so one m64n64k16 wgmma (B read
//   MN-major: W1's hidden columns are contiguous) computes val and gate
//   with the same accumulator layout: each thread holds matching (val,
//   gate) pairs and applies + b1 and the GEGLU in its registers.
// - W1 streams through a ring of k-slabs (up to 256 rows: few, large TMA
//   boxes), W2's chunk rows through a second ring, each stage with a full
//   mbarrier.  Every warp counts itself out of a stage when its products
//   have read it; the warp that completes the count refills the stage at
//   once.  No thread waits for another to release, so the consumers run
//   out of step and one's GEGLU overlaps the other's products (thread 0
//   issuing every load after waiting on empty barriers was much slower).
//   A chunk's products are issued back to back: the wgmma_wait trails the
//   issue by LAG slabs.
// - For CP <= 320, a_j is repacked in registers into bf16 A fragments and
//   the down-projection out += a_j . W2_j is an RS wgmma with W2's rows
//   read MN-major (as flash reads V); it runs while the next chunk's
//   up-projection is issued.
// - Epilogue: out + b2 + y in fp32, rounded once to bf16 into the consumer's
//   part of the Xn tile (swizzled), then TMA stores, which clip rows past
//   `rows` and columns past c.
// - Host side: the four tensor maps are encoded per launch (sm90.cuh) and
//   passed as __grid_constant__ parameters.

#include "sm90.cuh"

namespace {

using sm90::pack_bf16;
using sm90::swz;

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int NWARPS = NTHREADS / 32;
constexpr int SMEM_LIMIT = 232448;
constexpr int CB = 64;         // columns per swizzled column block

// The block's shape for the padded width CP.
template <int CP>
struct Geo {
  static_assert(CP % CB == 0 && CP <= 640, "CP: a multiple of 64 up to 640");
  static constexpr int NC = CP <= 320 ? 1 : 2;   // consumers per row tile
  static constexpr int BR = NC == 1 ? 128 : 64;  // rows per block
  static constexpr int HC = 32 * NC;             // hidden columns per chunk
  // W1 rows per slab: few, large TMA boxes (at most 256 rows)
  static constexpr int KS = NC == 2 ? 64 : CP <= 256 ? CP : CP / 2;
  static constexpr int NSL = CP / KS;            // slabs per chunk
  static constexpr int KW = HC;                  // W2 rows per chunk
  static constexpr int S2 = NC == 1 ? 2 : 1;     // W2 ring stages
  // output columns of consumer 0 and of consumer 1
  static constexpr int CO0 = NC == 1 ? CP : CB * ((CP / CB + 1) / 2);
  static constexpr int CO1 = NC == 1 ? CP : CP - CO0;
  static constexpr int XN_BYTES = CP * BR * 2;
  static constexpr int PART = KS * 128;  // a consumer's val | gate blocks
  static constexpr int SLAB = NC * PART;
  static constexpr int W2E = CP * KW * 2;        // one W2 chunk
  static constexpr int EX_BYTES = NC == 2 ? 2 * 64 * 128 : 0;  // a_j, twice
  static constexpr int BAR_BYTES = 512;
  static constexpr int FIXED = XN_BYTES + S2 * W2E + EX_BYTES;
  static constexpr int S1_FIT = (SMEM_LIMIT - 1024 - BAR_BYTES - FIXED) / SLAB;
  static constexpr int S1 = S1_FIT < 2 * NSL ? S1_FIT : 2 * NSL;  // W1 ring
  // slabs issued before the first is waited for and released: a whole
  // chunk where the ring holds two, else half the ring
  static constexpr int LAG = S1 >= 2 * NSL ? NSL : S1 / 2;
  static constexpr int W1_OFF = XN_BYTES;
  static constexpr int W2_OFF = W1_OFF + S1 * SLAB;
  static constexpr int EX_OFF = W2_OFF + S2 * W2E;
  static constexpr int BAR_OFF = EX_OFF + EX_BYTES;
  static constexpr int NBARS = 1 + S1 + S2;  // y, the rings' full barriers
  static constexpr int SMEM = BAR_OFF + BAR_BYTES + 1024;  // + base alignment
  static_assert(S1 >= 2, "the W1 ring needs two slabs");
  // then one release counter per stage
  static_assert(8 * NBARS + 4 * (S1 + S2) <= BAR_BYTES, "too many barriers");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

// A consumer's output accumulator over CO columns, as one or two wgmma
// widths (a 320-wide output is 256 + 64).
template <int CO>
struct Out {
  static constexpr int P0 = CO < 256 ? CO : 256;
  static constexpr int P1 = CO - P0;
  static_assert(P1 == 0 || P1 == 64, "output split");
  float a0[P0 / 2];
  float a1[P1 > 0 ? P1 / 2 : 2];
};

struct Params {
  const bf16* y;
  const float* gamma;
  const float* beta;
  const bf16* b1;
  const bf16* b2;
  int rows, c;
  float eps;
};

// What the consumers share: shared-memory regions, barriers, maps.
struct Ctx {
  uint8_t *xn, *w1s, *w2s, *ex;
  uint64_t *full1, *full2;
  int *rel1, *rel2;  // warps that have released each stage's current use
  const CUtensorMap *tw1, *tw2, *tout;
  Params prm;
  int r0, nch, n1;  // first row, chunks, W1 slab uses
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 bf16x2(const bf16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// TMA loads: W1 slab use u (chunk u / NSL, slab u % NSL), W2 chunk j;
// uses past the last are not issued.
template <int CP>
__device__ __forceinline__ void issue_w1(const Ctx& x, int u) {
  using G = Geo<CP>;
  if (u >= x.n1) return;
  const int j = u / G::NSL, s = u % G::NSL, st = u % G::S1;
  sm90::mbar_expect_tx(x.full1 + st, G::SLAB);
  const int inner = 4 * x.prm.c;
#pragma unroll
  for (int w = 0; w < G::NC; ++w) {
    uint8_t* dst = x.w1s + st * G::SLAB + w * G::PART;
    const int col = j * G::HC + 32 * w;
    sm90::tma_load_2d(dst, x.tw1, x.full1 + st, col, s * G::KS);
    sm90::tma_load_2d(dst + G::KS * 64, x.tw1, x.full1 + st, inner + col,
                      s * G::KS);
  }
}

template <int CP>
__device__ __forceinline__ void issue_w2(const Ctx& x, int j) {
  using G = Geo<CP>;
  if (j >= x.nch) return;
  const int st = j % G::S2;
  sm90::mbar_expect_tx(x.full2 + st, G::W2E);
#pragma unroll
  for (int cb = 0; cb < CP / CB; ++cb)
    sm90::tma_load_2d(x.w2s + st * G::W2E + cb * G::KW * 128, x.tw2,
                      x.full2 + st, cb * CB, j * G::KW);
}

// A consumer is done with W1 slab use u (or W2 chunk j): each warp counts
// itself out, and the warp that completes the count (both consumers done)
// refills the stage with the use one ring length later.  No thread waits
// for another here, so the two consumers need not run in step, and the
// refill is issued as soon as the stage is free.
__device__ __forceinline__ bool last_release(int* count) {
  __threadfence_block();  // this warp's reads of the stage are done
  if (atomicAdd(count, 1) != NWARPS - 1) return false;
  *count = 0;  // nobody releases the stage again before its refill lands
  __threadfence_block();
  return true;
}

template <int CP>
__device__ __forceinline__ void release_w1(const Ctx& x, int u) {
  if (threadIdx.x % 32 == 0 && last_release(x.rel1 + u % Geo<CP>::S1))
    issue_w1<CP>(x, u + Geo<CP>::S1);
}

template <int CP>
__device__ __forceinline__ void release_w2(const Ctx& x, int j) {
  if (threadIdx.x % 32 == 0 && last_release(x.rel2 + j % Geo<CP>::S2))
    issue_w2<CP>(x, j + Geo<CP>::S2);
}

// One consumer warpgroup `wg` with CO output columns.
template <int CP, int CO>
__device__ __forceinline__ void consume(const Ctx& x, int wg) {
  using G = Geo<CP>;
  using O = Out<CO>;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int part = G::NC == 2 ? wg : 0;           // hidden half of a chunk
  const int rows_off = G::NC == 1 ? wg * 64 : 0;  // this consumer's rows
  const int co0 = G::NC == 2 && wg == 1 ? G::CO0 : 0;
  const int c = x.prm.c, inner = 4 * c;
  const uint8_t* xa = x.xn + rows_off * 128;

  O out;
#pragma unroll
  for (int i = 0; i < O::P0 / 2; ++i) out.a0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (O::P1 > 0 ? O::P1 / 2 : 2); ++i) out.a1[i] = 0.f;
  float h[32];         // [val | gate] of this consumer's 32 hidden columns
  uint32_t a[2][4];    // a_j as bf16 A fragments (CP <= 320)

  constexpr int LAG = G::LAG;

  for (int j = 0; j < x.nch; ++j) {
    // up-projection: [val | gate] (64 x 64) = Xn . W1 chunk j, slab by slab
    for (int s = 0; s < G::NSL; ++s) {
      const int u = j * G::NSL + s, st = u % G::S1;
      sm90::mbar_wait(x.full1 + st, (u / G::S1) & 1);
      const uint8_t* wb = x.w1s + st * G::SLAB + part * G::PART;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::KS / 16; ++kk) {
        const int ks = s * (G::KS / 16) + kk;  // k16 step over c
        const uint64_t da = sm90::desc_sw128(
            xa + (ks / 4) * G::BR * 128 + (ks % 4) * 32, 16);
        const uint64_t db = sm90::desc_sw64(wb + kk * 16 * 64, G::KS * 64);
        sm90::WgmmaSSt<64>::run(h, da, db, (s | kk) != 0);
      }
      sm90::wgmma_commit();
      sm90::fence_regs(h);
      if (s >= LAG) {
        // slab s - LAG read (and, first, the down-projection of chunk j - 1,
        // issued before slab 0)
        sm90::wgmma_wait<LAG>();
        sm90::fence_regs(h);
        release_w1<CP>(x, u - LAG);
        if (s == LAG && j > 0) release_w2<CP>(x, j - 1);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(h);
    for (int s = G::NSL > LAG ? G::NSL - LAG : 0; s < G::NSL; ++s)
      release_w1<CP>(x, j * G::NSL + s);
    if (G::NSL <= LAG && j > 0) release_w2<CP>(x, j - 1);

    // + b1 (bf16 adds), GEGLU: val element i pairs with gate element i + 16
    // (the same row and column of the chunk's val and gate halves); a_j
    // replaces val in h[0..15]
    const int hc0 = j * G::HC + part * 32;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = hc0 + n * 8 + 2 * qd;
      const float2 bv = bf16x2(x.prm.b1 + col);
      const float2 bg = bf16x2(x.prm.b1 + inner + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float v = round_bf16(round_bf16(h[i]) + ((e & 1) ? bv.y : bv.x));
        const float gt =
            round_bf16(round_bf16(h[16 + i]) + ((e & 1) ? bg.y : bg.x));
        h[i] = v * ((0.5f * gt) * (1.f + erff(gt * 0.7071067811865476f)));
      }
    }

    const int st2 = j % G::S2;
    const uint8_t* w2 = x.w2s + st2 * G::W2E + (co0 / CB) * G::KW * 128;
    if constexpr (G::NC == 1) {
      // a_j -> bf16 A fragments (the accumulator layout of columns
      // 16kk..16kk+15 is the A layout of k16 step kk)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        a[kk][0] = pack_bf16(h[8 * kk], h[8 * kk + 1]);
        a[kk][1] = pack_bf16(h[8 * kk + 2], h[8 * kk + 3]);
        a[kk][2] = pack_bf16(h[8 * kk + 4], h[8 * kk + 5]);
        a[kk][3] = pack_bf16(h[8 * kk + 6], h[8 * kk + 7]);
      }
      sm90::mbar_wait(x.full2 + st2, (j / G::S2) & 1);
      sm90::fence_regs(out.a0);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        sm90::WgmmaRS<O::P0>::run(
            out.a0, a[kk], sm90::desc_sw128(w2 + kk * 16 * 128, G::KW * 128));
        if constexpr (O::P1 > 0)
          sm90::WgmmaRS<O::P1>::run(
              out.a1, a[kk],
              sm90::desc_sw128(w2 + (O::P0 / CB) * G::KW * 128 + kk * 16 * 128,
                               G::KW * 128));
      }
    } else {
      // this consumer's half of a_j into the exchange tile (K-major, 64
      // rows x 64 hidden columns), then both halves through SS wgmma
      uint8_t* eb = x.ex + (j & 1) * 64 * 128;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = part * 32 + n * 8 + 2 * qd;
        const int row = warp * 16 + g;
        *reinterpret_cast<uint32_t*>(eb + swz(row, col, 64)) =
            pack_bf16(h[4 * n], h[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(eb + swz(row + 8, col, 64)) =
            pack_bf16(h[4 * n + 2], h[4 * n + 3]);
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(1, 256);
      sm90::mbar_wait(x.full2 + st2, (j / G::S2) & 1);
      sm90::fence_regs(out.a0);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sm90::desc_sw128(eb + kk * 32, 16);
        sm90::WgmmaSSt<O::P0>::run(
            out.a0, da, sm90::desc_sw128(w2 + kk * 16 * 128, G::KW * 128), 1);
        if constexpr (O::P1 > 0)
          sm90::WgmmaSSt<O::P1>::run(
              out.a1, da,
              sm90::desc_sw128(w2 + (O::P0 / CB) * G::KW * 128 + kk * 16 * 128,
                               G::KW * 128),
              1);
      }
    }
    sm90::wgmma_commit();
    sm90::fence_regs(out.a0);
    if constexpr (O::P1 > 0) sm90::fence_regs(out.a1);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(out.a0);
  if constexpr (O::P1 > 0) sm90::fence_regs(out.a1);

  // epilogue: y + (out + b2) in fp32 -> bf16 into this consumer's part of
  // the Xn tile (no up-projection reads it any more), then TMA stores
  uint8_t* stage = x.xn + rows_off * 128;
  const int row = warp * 16 + g;
  const int grow = x.r0 + rows_off + row;
  auto put = [&](const float* acc, int n, int col) {
    if (col >= c) return;
    const float2 bb = bf16x2(x.prm.b2 + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2 yy = make_float2(0.f, 0.f);
      if (grow + 8 * hh < x.prm.rows)
        yy = bf16x2(x.prm.y + (long long)(grow + 8 * hh) * c + col);
      const float o0 = acc[4 * n + 2 * hh] + bb.x;
      const float o1 = acc[4 * n + 2 * hh + 1] + bb.y;
      *reinterpret_cast<uint32_t*>(stage + swz(row + 8 * hh, col, G::BR)) =
          pack_bf16(yy.x + o0, yy.y + o1);
    }
  };
#pragma unroll
  for (int n = 0; n < O::P0 / 8; ++n) put(out.a0, n, co0 + n * 8 + 2 * qd);
  if constexpr (O::P1 > 0) {
#pragma unroll
    for (int n = 0; n < O::P1 / 8; ++n)
      put(out.a1, n, co0 + O::P0 + n * 8 + 2 * qd);
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(2 + wg, 128);
  if (t == 0 && x.r0 + rows_off < x.prm.rows) {
    for (int cb = co0 / CB; cb < (co0 + CO) / CB && cb * CB < c; ++cb)
      sm90::tma_store_2d(x.tout, stage + cb * G::BR * 128, cb * CB,
                         x.r0 + rows_off);
    sm90::tma_store_commit_and_wait();
  }
}

template <int CP>
__global__ void __launch_bounds__(NTHREADS, 1)
geglu_ff_sm90_kernel(const __grid_constant__ CUtensorMap ty,
                     const __grid_constant__ CUtensorMap tw1,
                     const __grid_constant__ CUtensorMap tw2,
                     const __grid_constant__ CUtensorMap tout, Params prm) {
  using G = Geo<CP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* full_y = bars;
  Ctx x;
  x.xn = smem;
  x.w1s = smem + G::W1_OFF;
  x.w2s = smem + G::W2_OFF;
  x.ex = smem + G::EX_OFF;
  x.full1 = bars + 1;
  x.full2 = x.full1 + G::S1;
  x.rel1 = reinterpret_cast<int*>(bars + G::NBARS);
  x.rel2 = x.rel1 + G::S1;
  x.tw1 = &tw1;
  x.tw2 = &tw2;
  x.tout = &tout;
  x.prm = prm;
  x.r0 = blockIdx.x * G::BR;
  x.nch = 4 * prm.c / G::HC;
  x.n1 = x.nch * G::NSL;
  const int c = prm.c;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_y, 1);
    for (int s = 0; s < G::S1 + G::S2; ++s) sm90::mbar_init(x.full1 + s, 1);
    for (int s = 0; s < G::S1 + G::S2; ++s) x.rel1[s] = 0;
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the y tile first, then the rings' first uses, all in flight during
    // the LayerNorm
    sm90::prefetch_tmap(&tw1);
    sm90::prefetch_tmap(&tw2);
    sm90::mbar_expect_tx(full_y, G::XN_BYTES);
    for (int cb = 0; cb < CP / CB; ++cb)
      sm90::tma_load_2d(x.xn + cb * G::BR * 128, &ty, full_y, cb * CB, x.r0);
    for (int u = 0; u < G::S1; ++u) issue_w1<CP>(x, u);
    for (int j = 0; j < G::S2; ++j) issue_w2<CP>(x, j);
  }

  // LayerNorm in place: a warp per row, 16-byte chunks (8 columns); chunks
  // past c are the TMA's zeros and stay so
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    constexpr int RPW = G::BR / NWARPS;  // rows per warp
    constexpr int NCH = (CP / 8 + 31) / 32;       // chunks per lane
    const int nvalid = c / 8;
    const float inv_c = 1.f / c;
    sm90::mbar_wait(full_y, 0);
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      float v[NCH][8];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int ch = lane + 32 * i;
        if (ch < nvalid) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              x.xn + swz(r, ch * 8, G::BR));
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            v[i][k] = __bfloat162float(e[k]);
            sum += v[i][k];
          }
        }
      }
      const float mu = warp_sum(sum) * inv_c;
      float s2 = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        if (lane + 32 * i < nvalid) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = v[i][k] - mu;
            s2 += d * d;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(s2) * inv_c + prm.eps);
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int ch = lane + 32 * i;
        if (ch < nvalid) {
          const float4* gp = reinterpret_cast<const float4*>(prm.gamma + ch * 8);
          const float4* bp = reinterpret_cast<const float4*>(prm.beta + ch * 8);
          const float4 g0 = __ldg(gp), g1 = __ldg(gp + 1);
          const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
          const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          uint4 raw;
          uint32_t* o = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
          for (int k = 0; k < 8; k += 2) {
            const float n0 = __fadd_rn(
                __fmul_rn(__fmul_rn(v[i][k] - mu, rstd), gm[k]), bt[k]);
            const float n1 = __fadd_rn(
                __fmul_rn(__fmul_rn(v[i][k + 1] - mu, rstd), gm[k + 1]),
                bt[k + 1]);
            o[k / 2] = pack_bf16(n0, n1);
          }
          *reinterpret_cast<uint4*>(x.xn + swz(r, ch * 8, G::BR)) = raw;
        }
      }
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (G::NC == 1 || wg == 0)
    consume<CP, G::CO0>(x, wg);
  else
    consume<CP, G::CO1>(x, wg);
}

// ---------------------------------------------------------------------------
// host side

template <int CP>
cudaError_t launch(const void* y, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int rows, int c, float eps,
                   cudaStream_t stream) {
  using G = Geo<CP>;
  const cuuint64_t C = (cuuint64_t)c, R = (cuuint64_t)rows;
  const cuuint64_t act_dims[2] = {C, R}, act_str[1] = {C * 2};
  const cuuint32_t y_box[2] = {CB, G::BR}, out_box[2] = {CB, 64};
  // W1 in boxes of 32 columns (64-byte swizzle): a chunk's val and gate
  // columns, two boxes, land side by side
  const cuuint64_t w1_dims[2] = {8 * C, C}, w1_str[1] = {16 * C};
  const cuuint32_t w1_box[2] = {32, (cuuint32_t)G::KS};
  const cuuint64_t w2_dims[2] = {C, 4 * C}, w2_str[1] = {C * 2};
  const cuuint32_t w2_box[2] = {CB, (cuuint32_t)G::KW};
  CUtensorMap ty, tw1, tw2, to;
  if (!sm90::make_map_nd(&ty, y, 2, act_dims, act_str, y_box)
      || !sm90::make_map_nd(&to, out, 2, act_dims, act_str, out_box)
      || !sm90::make_map_nd(&tw1, w1, 2, w1_dims, w1_str, w1_box,
                            CU_TENSOR_MAP_SWIZZLE_64B)
      || !sm90::make_map_nd(&tw2, w2, 2, w2_dims, w2_str, w2_box))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err =
      sm90::raise_smem(geglu_ff_sm90_kernel<CP>, G::SMEM, raised);
  if (err != cudaSuccess) return err;
  const Params prm{static_cast<const bf16*>(y), static_cast<const float*>(gamma),
                   static_cast<const float*>(beta), static_cast<const bf16*>(b1),
                   static_cast<const bf16*>(b2), rows, c, eps};
  const int grid = (rows + G::BR - 1) / G::BR;
  geglu_ff_sm90_kernel<CP>
      <<<grid, NTHREADS, G::SMEM, stream>>>(ty, tw1, tw2, to, prm);
  return cudaGetLastError();
}

}  // namespace

// y/out (rows, c), w1 (c, 8c), b1 (8c), w2 (4c, c), b2 (c): bf16, contiguous,
// 32-byte aligned; gamma/beta (c): fp32.  c a multiple of 32 up to 320, or
// of 64 up to 640.  Returns cudaGetLastError() after the launch.
extern "C" int sdbc_geglu_ff(const void* y, const void* gamma, const void* beta,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int rows, int c,
                             float eps, void* stream) {
  if (rows <= 0 || c <= 0 || c % 32 || c > 640 || (c > 320 && c % 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDBC_GEGLU_CASE(CP)                                                 \
  case CP:                                                                 \
    return (int)launch<CP>(y, gamma, beta, w1, b1, w2, b2, out, rows, c, eps, \
                           s);
  switch ((c + CB - 1) / CB * CB) {
    SDBC_GEGLU_CASE(64) SDBC_GEGLU_CASE(128) SDBC_GEGLU_CASE(192)
    SDBC_GEGLU_CASE(256) SDBC_GEGLU_CASE(320) SDBC_GEGLU_CASE(384)
    SDBC_GEGLU_CASE(448) SDBC_GEGLU_CASE(512) SDBC_GEGLU_CASE(576)
    SDBC_GEGLU_CASE(640)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDBC_GEGLU_CASE
}
