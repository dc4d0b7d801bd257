// Flash-attention forwards for Hopper (sm_90a) at head dims above 256 (the
// VAE's single 512-wide head), bf16, on TMA-fed wgmma.
//
// Replaces the JAX package's Pallas kernels, for head dims in (256, 512]
// (flash_fwd_sm90.cu takes those up to 256):
//   TT = false <- sdbc_tpu/ops/flash_attention.py _fwd_kernel (via _flash_fwd)
//   TT = true  <- sdbc_tpu/ops/flash_attention_tt.py _fwd_tt_kernel (via
//                 _flash_fwd_tt): head-dim-major operands and output
//   FIXED      <- sdbc_tpu/ops/flash_attention.py _fixed_kernel_bshd,
//                 _fixed_kernel_raw, _fixed_kernel (the fixed cap, the
//                 VAE's head under SDBC_ATTN_IMPL=inference): no running
//                 max, p = exp2(min(s, 60)), o = acc / max(l, 1e-37), no LSE
//
// Math (flash_fwd_sm90.cu's ONLINE variant): q is prescaled by scale*log2e
// in fp32 and rounded once to bf16, so s = q.k^T (fp32 accumulate) is in
// log2 units; a running row max m, O rescaled by exp2(m_old - m_new) per KV
// tile, p = exp2(s - m) rounded to bf16 before P.V; o = acc / l and the
// natural-log lse = m*ln2 + ln(l), fp32.  Keys past the end are masked on
// the last KV tile only (p = 0).
//
// What bounds it on the H100: per score 4*D tensor FLOPs and one exp2; at
// (1, 1, 4096, 512) 34.4 GFLOP, 0.0347 ms at 989 TFLOP/s (the exp2s take
// 4.3 us, the bytes 5 us).  Every 64-row q tile streams all of K and V from
// the L2 (64 FLOPs per byte), so the L2's bandwidth to the SMs may set the
// pace before the tensor cores do.
//
// Design:
// - A 64 x 512 fp32 O does not fit one warpgroup's registers, and ptxas
//   holds a 384-thread block to 168 registers a thread whatever setmaxnreg
//   asks.  A block is 256 threads, two consumer warpgroups and no producer
//   warp (as geglu_ff_sm90.cu): both own the same 64 q rows, and consumer w
//   owns the head-dim half [256w, 256w + 256): a 64 x 256 fp32 O, 128
//   registers a thread.
// - Consumer w computes the partial S_w = Q[:, half w] . K[:, half w]^T on
//   wgmma; the two swap their fp32 partials through shared memory (8 KB a
//   32-key tile, two buffers each, one named barrier a tile) and both form
//   S = S_0 + S_1 in that order, so the row max, p and l are bit-identical
//   in both and no tensor work is repeated.  P stays in registers as the A
//   operand of O_w += P . V[:, half w] (RS wgmma, V read through the
//   descriptor, no transposed copy).
// - 64 q tiles make too few blocks at B.H = 1, so a cluster of two CTAs
//   shares each q tile: CTA r walks the keys [r * half, ...), half =
//   ceil(Sk / 128) * 64.  At the end the pair swaps over distributed shared
//   memory the un-normalised O of the head-dim half the peer finalises and
//   each row's (m, l), into the peer's freed K ring; CTA r finalises half
//   r.  Both halves combine the first key half's partial before the
//   second's with explicit roundings, o = (O_0 a_0 + O_1 a_1) / l, so the
//   result does not depend on which CTA finishes it (the fixed cap: a_0 =
//   a_1 = 1, l = l_0 + l_1).  CTA 0 writes the
//   LSE.  A CTA with no keys (Sk <= 64) carries m = -1e30, l = 0 and O = 0,
//   and the result is exactly its peer's.
// - Shared memory: Q (64 x 512 bf16, 64 KB), K and V tiles of 32 keys in a
//   2-stage ring each (4 x 32 KB) and the S partials (4 x 8 KB): 224 KB.
// - TMA loads every tile through 4-D tensor maps built from the caller's
//   strides: (D, S, H, B) in the natural layout (stacks of 64-column blocks,
//   128-byte swizzle), (S, D, H, B) in the head-dim-major one (Q and O as
//   64-position blocks of head-dim rows, 128-byte swizzle; the 32-key K^T
//   and V^T tiles in the 64-byte swizzle, whose rows are 32 positions, so
//   both operands of Q.K^T are read MN-major and V^T K-major).  Rows and
//   columns past S and D arrive as zeros.  No thread waits to issue loads:
//   the warp that releases a stage last refills it.  The epilogue stages O
//   in bf16 over the finalising consumer's half of the Q tile and
//   TMA-stores it.
// - The head dim is padded to 256 + 16 * KS1 (KS1 in {4, 8, 12, 16}):
//   consumer 1's Q.K^T takes KS1 k16 steps and its P.V 16 * KS1 output
//   columns; in the natural layout the column blocks past them are not
//   loaded.

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::pack_bf16;
using sm90::quad_max;
using sm90::quad_sum;
using sm90::swz;

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int NWARPS = NTHREADS / 32;
constexpr int BQ = 64;         // q rows per CTA
constexpr int BK = 32;         // keys per tile
constexpr int STAGES = 2;
constexpr int CB = 64;         // columns per 128-byte-swizzled column block
constexpr int HALF = 256;      // head-dim columns per consumer
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;
constexpr float CAP = 60.f;  // the fixed cap's log2-space clamp

constexpr int Q_BYTES = BQ * 2 * HALF * 2;
constexpr int KV_BYTES = BK * 2 * HALF * 2;  // one K or V tile
constexpr int X_BYTES = 128 * (BK / 2) * 4;  // one consumer's S partial
constexpr int K_OFF = Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
constexpr int X_OFF = V_OFF + STAGES * KV_BYTES;  // [consumer][tile parity]
constexpr int BAR_OFF = X_OFF + 4 * X_BYTES;
// full_q, full_k[STAGES], full_v[STAGES], then a release count per stage
constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES) + 4 * 2 * STAGES;
constexpr int SMEM = BAR_OFF + BAR_BYTES + 1024;  // + room to align the base
static_assert(SMEM <= 232448, "shared memory");
static_assert(STAGES * KV_BYTES >= 128 * (HALF / 2) * 4,
              "the K ring holds the peer's half of O");

// Column blocks loaded in the natural layout: consumer 0's four and
// consumer 1's KS1 / 4.
template <int KS1>
__host__ __device__ constexpr int ncb() { return 4 + KS1 / 4; }

struct Params {
  int H, Sq, Sk;
  float qscale;
  float* lse;  // (B, H, Sq) fp32; unused by the fixed cap
};

// What the consumers share: shared memory, barriers, maps, this CTA's keys.
struct Ctx {
  uint8_t* smem;
  uint64_t *full_q, *full_k, *full_v;
  int *rel_k, *rel_v;  // warps that have released each stage's current tile
  const CUtensorMap *tk, *tv, *to;
  Params prm;
  int q0, h, b, rank;
  int k0, kend, nk;  // this CTA's keys [k0, kend) in nk tiles
};

// K (or, with V, V) tile j of this CTA's keys, the keys [k0 + j BK, ...),
// into stage j % STAGES; tiles past the last are not issued.
template <int KS1, bool TT, bool V>
__device__ __forceinline__ void issue(const Ctx& x, int j) {
  if (j >= x.nk) return;
  const int s = j % STAGES, key = x.k0 + j * BK;
  const CUtensorMap* map = V ? x.tv : x.tk;
  uint8_t* dst = x.smem + (V ? V_OFF : K_OFF) + s * KV_BYTES;
  uint64_t* bar = (V ? x.full_v : x.full_k) + s;
  if (TT) {  // two boxes of 256 head-dim rows by 32 positions
    sm90::mbar_expect_tx(bar, KV_BYTES);
    for (int c = 0; c < 2; ++c)
      sm90::tma_load_4d(dst + c * HALF * 64, map, bar, key, c * HALF, x.h,
                        x.b);
  } else {
    sm90::mbar_expect_tx(bar, ncb<KS1>() * BK * 128);
    for (int c = 0; c < ncb<KS1>(); ++c)
      sm90::tma_load_4d(dst + c * BK * 128, map, bar, c * CB, key, x.h, x.b);
  }
}

// A warp is done with a stage: it counts itself out, and the warp that
// completes the count (both consumers done) refills the stage at once.
__device__ __forceinline__ bool last_release(int* count) {
  __threadfence_block();  // this warp's reads of the stage are done
  if (atomicAdd(count, 1) != NWARPS - 1) return false;
  *count = 0;  // nobody releases the stage again before its refill lands
  __threadfence_block();
  return true;
}

template <int KS1, bool TT, bool V>
__device__ __forceinline__ void release(const Ctx& x, int j) {
  if (threadIdx.x % 32 == 0
      && last_release((V ? x.rel_v : x.rel_k) + j % STAGES))
    issue<KS1, TT, V>(x, j + STAGES);
}

// One consumer warpgroup W: its head-dim half of the scores and of O.
template <int KS1, bool TT, bool FIXED, int W>
__device__ __forceinline__ void consume(const Ctx& x) {
  constexpr int NKS = W == 0 ? HALF / 16 : KS1;  // k16 steps of S_W
  constexpr int NV = 16 * NKS;                    // columns of O_W
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  // this consumer's half of the Q tile: column blocks 4W.. or (TT)
  // head-dim rows 256W..; NKS * 2 KB of it is read, contiguous either way
  uint8_t* const qw = x.smem + (TT ? W * HALF * 128 : W * 4 * BQ * 128);

  // Q: prescale by scale*log2e in fp32, round once to bf16
  sm90::mbar_wait(x.full_q, 0);
  for (int i = t; i < NKS * 128; i += 128) {  // 16-byte chunks
    uint4* ptr = reinterpret_cast<uint4*>(qw + i * 16);
    uint4 val = *ptr;
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = __float2bfloat16(__bfloat162float(e[k]) * x.prm.qscale);
    *ptr = val;
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(2 + W, 128);

  float o[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, rows r0 and r0 + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums
  float a0 = 1.f, a1 = 1.f;          // pending rescale of O
  const bool ragged = (x.kend - x.k0) % BK != 0;

  auto k_tile = [&](int j) {
    return x.smem + K_OFF + (j % STAGES) * KV_BYTES;
  };
  auto v_tile = [&](int j) {
    return x.smem + V_OFF + (j % STAGES) * KV_BYTES;
  };
  // S_W (64 x BK) = Q_W . K_W^T: NKS k16 steps (TT: both operands MN-major)
  auto qk = [&](const uint8_t* kt) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if constexpr (TT)
        sm90::WgmmaSStt<BK>::run(
            s, sm90::desc_sw128(qw + ks * 2048, HALF * 128),
            sm90::desc_sw64(kt + W * HALF * 64 + ks * 1024, HALF * 64),
            ks > 0);
      else
        sm90::WgmmaSS<BK>::run(
            s, sm90::desc_sw128(qw + (ks / 4) * BQ * 128 + (ks % 4) * 32, 16),
            sm90::desc_sw128(kt + (4 * W + ks / 4) * BK * 128 + (ks % 4) * 32,
                             16),
            ks > 0);
    }
  };
  // O_W (64 x NV) += P (registers) . V_W: V read MN-major from its row
  // tile, or (TT) K-major from the V^T tile
  auto pv = [&](const uint8_t* vt) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (TT)
        sm90::WgmmaRSk<NV>::run(
            o, p[kk], sm90::desc_sw64(vt + W * HALF * 64 + kk * 32, 16));
      else
        sm90::WgmmaRS<NV>::run(
            o, p[kk],
            sm90::desc_sw128(vt + 4 * W * BK * 128 + kk * 16 * 128, BK * 128));
    }
  };
  // S = S_0 + S_1: each consumer posts its partial (thread t's values as
  // 16-byte chunks, neighbouring threads on neighbouring chunks) and adds
  // the other's, S_0 first
  auto exchange = [&](int j) {
    float4* mine = reinterpret_cast<float4*>(
        x.smem + X_OFF + (2 * W + (j & 1)) * X_BYTES);
    const float4* other = reinterpret_cast<const float4*>(
        x.smem + X_OFF + (2 * (1 - W) + (j & 1)) * X_BYTES);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      mine[i * 128 + t] =
          make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    sm90::bar_sync(1, 256);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float4 v = other[i * 128 + t];
      const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * i + e] = W == 0 ? __fadd_rn(s[4 * i + e], u[e])
                              : __fadd_rn(u[e], s[4 * i + e]);
    }
  };
  // exponentials of S_j in place, and the row statistics
  auto softmax = [&](int j) {
    if (ragged && j == x.nk - 1) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int col = x.k0 + j * BK + n * 8 + 2 * qd;
        if (col >= x.kend) s[4 * n] = s[4 * n + 2] = NEG_INF;
        if (col + 1 >= x.kend) s[4 * n + 1] = s[4 * n + 3] = NEG_INF;
      }
    }
    if constexpr (FIXED) {  // p = exp2(min(s, 60)); masked keys give 0
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * n + e] = ex2(fminf(s[4 * n + e], CAP));
        l0 += s[4 * n] + s[4 * n + 1];
        l1 += s[4 * n + 2] + s[4 * n + 3];
      }
      return;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    a0 = ex2(m0 - mx0);
    a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = ex2(s[4 * n] - m0);
      s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
      s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
      s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  };
  // P_j as bf16 A fragments: chunks 2kk (a0: row g, a1: row g + 8) and
  // 2kk + 1 (a2, a3) of the S accumulator
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale = [&]() {
    if constexpr (FIXED) return;  // no running max
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) {
      o[4 * n] *= a0; o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1; o[4 * n + 3] *= a1;
    }
  };

  if (x.nk > 0) {
    // KV tile 0: S_0 alone
    sm90::mbar_wait(x.full_k, 0);
    sm90::wgmma_fence();
    qk(k_tile(0));
    sm90::wgmma_commit();
    sm90::fence_regs(s);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    release<KS1, TT, false>(x, 0);
    exchange(0);
    softmax(0);
    pack();

    for (int j = 1; j < x.nk; ++j) {
      const uint32_t ph = (j / STAGES) & 1, pph = ((j - 1) / STAGES) & 1;
      sm90::mbar_wait(x.full_k + j % STAGES, ph);
      sm90::wgmma_fence();
      qk(k_tile(j));
      sm90::wgmma_commit();
      sm90::fence_regs(s);
      rescale();
      sm90::mbar_wait(x.full_v + (j - 1) % STAGES, pph);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      pv(v_tile(j - 1));
      sm90::wgmma_commit();
      sm90::fence_regs(o);
      sm90::wgmma_wait<1>();  // S_j done, P_{j-1}.V_{j-1} may still run
      sm90::fence_regs(s);
      release<KS1, TT, false>(x, j);
      exchange(j);
      softmax(j);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release<KS1, TT, true>(x, j - 1);
      pack();
    }

    // the last P.V
    rescale();
    sm90::mbar_wait(x.full_v + (x.nk - 1) % STAGES,
                    ((x.nk - 1) / STAGES) & 1);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    pv(v_tile(x.nk - 1));
    sm90::wgmma_commit();
    sm90::fence_regs(o);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    release<KS1, TT, true>(x, x.nk - 1);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // ---- the pair's combine: CTA r finalises head-dim half r
  sm90::cluster_sync();  // both CTAs are done with their rings
  if (x.rank != W) {
    // the peer finalises this half: the un-normalised partial into its K
    // ring (thread t's values as 16-byte chunks), the rows' (m, l) into its
    // S-partial area
    const uint32_t dst = sm90::peer_addr(x.smem + K_OFF, x.rank ^ 1);
#pragma unroll
    for (int i = 0; i < NV / 8; ++i)
      sm90::st_peer_v4(dst + (i * 128 + t) * 16, o[4 * i], o[4 * i + 1],
                       o[4 * i + 2], o[4 * i + 3]);
    if (qd == 0) {
      const uint32_t ml = sm90::peer_addr(x.smem + X_OFF, x.rank ^ 1);
      sm90::st_peer_v2(ml + r0 * 8, m0, l0);
      sm90::st_peer_v2(ml + (r0 + 8) * 8, m1, l1);
    }
  }
  sm90::cluster_sync();  // the peer's partial has landed
  if (x.rank != W) return;

  // (m, l) of the first key half (CTA 0's) and the second, per row: the
  // weights a_first, a_second, 1 / l and the LSE, the same in either CTA
  const bool first = x.rank == 0;
  struct Row { float af, as, inv, lse; };
  auto combine = [&](float mo, float lo, int row) {
    const float* ml = reinterpret_cast<const float*>(x.smem + X_OFF) + 2 * row;
    const float mf = first ? mo : ml[0], ms = first ? ml[0] : mo;
    const float lf = first ? lo : ml[1], ls = first ? ml[1] : lo;
    Row r;
    if constexpr (FIXED) {  // the halves' sums add; no max to align
      r.af = r.as = 1.f;
      r.inv = 1.f / fmaxf(__fadd_rn(lf, ls), 1e-37f);
      r.lse = 0.f;
      return r;
    }
    const float m = fmaxf(mf, ms);
    r.af = mf == m ? 1.f : ex2(mf - m);
    r.as = ms == m ? 1.f : ex2(ms - m);
    const float l = __fadd_rn(__fmul_rn(lf, r.af), __fmul_rn(ls, r.as));
    r.inv = 1.f / l;
    r.lse = m * LN2 + logf(l);
    return r;
  };
  const Row ra = combine(m0, l0, r0), rb = combine(m1, l1, r0 + 8);

  // o = (O_first a_first + O_second a_second) / l -> bf16 over this
  // consumer's half of the Q tile (in the swizzled layout), then TMA stores
  const float4* peer = reinterpret_cast<const float4*>(x.smem + K_OFF);
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const float4 v = peer[n * 128 + t];
    const float u[4] = {v.x, v.y, v.z, v.w};
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Row& r = e < 2 ? ra : rb;
      const float of = first ? o[4 * n + e] : u[e];
      const float os = first ? u[e] : o[4 * n + e];
      out[e] = __fadd_rn(__fmul_rn(of, r.af), __fmul_rn(os, r.as)) * r.inv;
    }
    const int col = n * 8 + 2 * qd;  // within the half
    if constexpr (TT) {  // O^T: head-dim row col, position r0
      bf16* ot = reinterpret_cast<bf16*>(qw);
      ot[swz(col, r0, HALF) / 2] = __float2bfloat16(out[0]);
      ot[swz(col + 1, r0, HALF) / 2] = __float2bfloat16(out[1]);
      ot[swz(col, r0 + 8, HALF) / 2] = __float2bfloat16(out[2]);
      ot[swz(col + 1, r0 + 8, HALF) / 2] = __float2bfloat16(out[3]);
    } else {
      *reinterpret_cast<uint32_t*>(qw + swz(r0, col, BQ)) =
          pack_bf16(out[0], out[1]);
      *reinterpret_cast<uint32_t*>(qw + swz(r0 + 8, col, BQ)) =
          pack_bf16(out[2], out[3]);
    }
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(2 + W, 128);
  if (t == 0) {
    if (TT) {
      sm90::tma_store_4d(x.to, qw, x.q0, W * HALF, x.h, x.b);
    } else {
      for (int c = 0; c < NV / CB; ++c)
        sm90::tma_store_4d(x.to, qw + c * BQ * 128, (4 * W + c) * CB, x.q0,
                           x.h, x.b);
    }
    sm90::tma_store_commit_and_wait();
  }
  if (!FIXED && W == 0 && qd == 0) {
    const int row = x.q0 + r0;
    float* lb = x.prm.lse + ((long long)x.b * x.prm.H + x.h) * x.prm.Sq;
    if (row < x.prm.Sq) lb[row] = ra.lse;
    if (row + 8 < x.prm.Sq) lb[row + 8] = rb.lse;
  }
}

template <int KS1, bool TT, bool FIXED>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
flash_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           Params prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  Ctx x;
  x.smem = smem;
  x.full_q = bars;
  x.full_k = bars + 1;
  x.full_v = x.full_k + STAGES;
  x.rel_k = reinterpret_cast<int*>(bars + 1 + 2 * STAGES);
  x.rel_v = x.rel_k + STAGES;
  x.tk = &tk;
  x.tv = &tv;
  x.to = &to;
  x.prm = prm;
  x.q0 = (blockIdx.x / 2) * BQ;
  x.h = blockIdx.y;
  x.b = blockIdx.z;
  x.rank = (int)sm90::cluster_ctarank();
  const int half = (prm.Sk + 2 * CB - 1) / (2 * CB) * CB;
  x.k0 = x.rank * half;
  x.kend = x.rank == 0 ? min(half, prm.Sk) : prm.Sk;
  x.nk = x.kend > x.k0 ? (x.kend - x.k0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(x.full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(x.full_k + s, 1);
      sm90::mbar_init(x.full_v + s, 1);
      x.rel_k[s] = x.rel_v[s] = 0;
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Q, then the rings' first tiles, all in flight during the prescale
    sm90::prefetch_tmap(&tk);
    sm90::prefetch_tmap(&tv);
    if (TT) {
      sm90::mbar_expect_tx(x.full_q, Q_BYTES);
      for (int c = 0; c < 2; ++c)
        sm90::tma_load_4d(smem + c * HALF * 128, &tq, x.full_q, x.q0,
                          c * HALF, x.h, x.b);
    } else {
      sm90::mbar_expect_tx(x.full_q, ncb<KS1>() * BQ * 128);
      for (int c = 0; c < ncb<KS1>(); ++c)
        sm90::tma_load_4d(smem + c * BQ * 128, &tq, x.full_q, c * CB, x.q0,
                          x.h, x.b);
    }
    for (int j = 0; j < STAGES; ++j) {
      issue<KS1, TT, false>(x, j);
      issue<KS1, TT, true>(x, j);
    }
  }
  if (threadIdx.x < 128)
    consume<KS1, TT, FIXED, 0>(x);
  else
    consume<KS1, TT, FIXED, 1>(x);
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

using sm90::View;

template <int KS1, bool TT, bool FIXED>
cudaError_t launch(const View& q, const View& k, const View& v, const View& o,
                   float* lse, int B, int H, int Sq, int Sk, int D,
                   float qscale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  const CUtensorMapSwizzle sw64 = CU_TENSOR_MAP_SWIZZLE_64B;
  const bool ok =
      TT ? sm90::make_map_tt(&tq, q, B, Sq, H, D, HALF)
               && sm90::make_map_tt(&tk, k, B, Sk, H, D, HALF, BK, sw64)
               && sm90::make_map_tt(&tv, v, B, Sk, H, D, HALF, BK, sw64)
               && sm90::make_map_tt(&to, o, B, Sq, H, D, HALF)
         : sm90::make_map(&tq, q, B, Sq, H, D, BQ)
               && sm90::make_map(&tk, k, B, Sk, H, D, BK)
               && sm90::make_map(&tv, v, B, Sk, H, D, BK)
               && sm90::make_map(&to, o, B, Sq, H, D, BQ);
  if (!ok) return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(
      flash_fwd_wide_sm90_kernel<KS1, TT, FIXED>, SMEM, raised);
  if (err != cudaSuccess) return err;
  const Params prm{H, Sq, Sk, qscale, lse};
  dim3 grid(2 * ((Sq + BQ - 1) / BQ), H, B);  // a cluster of two per q tile
  flash_fwd_wide_sm90_kernel<KS1, TT, FIXED>
      <<<grid, NTHREADS, SMEM, stream>>>(tq, tk, tv, to, prm);
  return cudaGetLastError();
}

// The instantiations: consumer 1's k16 steps, D - 256 rounded up to a
// multiple of 64 columns.
template <bool TT, bool FIXED>
int dispatch(const View& q, const View& k, const View& v, const View& o,
             float* lse, int B, int H, int Sq, int Sk, int D, float qscale,
             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= HALF || D > 2 * HALF
      || D % 8 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks1 = (D - HALF + 15) / 16;
#define SDBC_LAUNCH(KS1) \
  (int)launch<KS1, TT, FIXED>(q, k, v, o, lse, B, H, Sq, Sk, D, qscale, s)
  if (ks1 <= 4) return SDBC_LAUNCH(4);
  if (ks1 <= 8) return SDBC_LAUNCH(8);
  if (ks1 <= 12) return SDBC_LAUNCH(12);
  return SDBC_LAUNCH(16);
#undef SDBC_LAUNCH
}

}  // namespace

// K5 for head dims in (256, 512]: q/k/v/o bf16 (B, H, S, D) views with
// (batch, head, seq) strides in `st` (three per tensor in argument order,
// multiples of 8), a contiguous head dim, 16-byte aligned; `lse` a
// contiguous (B, H, Sq) fp32 output; D a multiple of 8.  Returns
// cudaGetLastError() after the launch.
extern "C" int sdbc_flash_fwd_wide_sm90(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Sq, int Sk, int D,
                                        const long long* st, float qscale,
                                        void* stream) {
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  return dispatch<false, false>(view(q, 0), view(k, 1), view(v, 2),
                                view(o, 3), static_cast<float*>(lse), B, H,
                                Sq, Sk, D, qscale, stream);
}

// K1-K3 for head dims in (256, 512]: the fixed cap over q/k/v/o as in
// sdbc_flash_fwd_wide_sm90, no LSE.
extern "C" int sdbc_flash_fixed_wide_sm90(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int Sq, int Sk, int D,
                                          const long long* st, float qscale,
                                          void* stream) {
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  return dispatch<false, true>(view(q, 0), view(k, 1), view(v, 2),
                               view(o, 3), nullptr, B, H, Sq, Sk, D, qscale,
                               stream);
}

// K9 for head dims in (256, 512]: as sdbc_flash_fwd_wide_sm90 over
// head-dim-major (batch, head, D, S) q/k/v/o, `st` holding (batch, head,
// head-dim row) strides, three per tensor; the sequence contiguous, every
// row 16-byte aligned with a stride that is a multiple of 8 (the output's
// too).
extern "C" int sdbc_flash_fwd_tt_wide_sm90(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int H, int Sq, int Sk,
                                           int D, const long long* st,
                                           float qscale, void* stream) {
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  return dispatch<true, false>(view(q, 0), view(k, 1), view(v, 2), view(o, 3),
                               static_cast<float*>(lse), B, H, Sq, Sk, D,
                               qscale, stream);
}
