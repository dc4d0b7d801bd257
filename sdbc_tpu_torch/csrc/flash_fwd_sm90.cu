// Flash-attention forward for Hopper (sm_90a), bf16, on TMA-fed wgmma: one
// kernel template for the fixed-cap sampling attention and the training
// forward that emits the log-sum-exp.
//
// Replaces the JAX package's Pallas kernels:
//   ONLINE = false <- sdbc_tpu/ops/flash_attention.py _fixed_kernel_bshd
//                     (projection layout), _fixed_kernel_raw (head-major) and
//                     _fixed_kernel (ragged sequences)
//   ONLINE = true  <- sdbc_tpu/ops/flash_attention.py _fwd_kernel (via
//                     _flash_fwd), for head dims up to 256
//   ONLINE, TT     <- sdbc_tpu/ops/flash_attention_tt.py _fwd_tt_kernel (via
//                     _flash_fwd_tt), for head dims up to 256
//
// Math (as the TPU kernels): q is prescaled by scale*log2e in fp32 and
// rounded once to bf16, so s = q.k^T (fp32 accumulate) is in log2 units.
//   fixed cap: p = exp2(min(s, 60)); l = sum(p) in fp32;
//              o = (p -> bf16).v / max(l, 1e-37); no LSE.
//   online:    a running row max m in fp32, O rescaled by exp2(m_old - m_new)
//              per KV tile, p = exp2(s - m) rounded to bf16 before P.V;
//              o = acc / l and the natural-log lse = m*ln2 + ln(l), fp32.
// Keys past Sk are masked on the last KV tile only (p = 0).
//
// What bounds it on the H100: per score 4*D tensor FLOPs and one exp2.  The
// card gives 989 TFLOP/s of bf16 tensor math against ~3.9 T exp2/s on its
// special-function units, so at D = 40 and 80 the exponentials set the
// bound, at D = 160 the tensor cores or (at 256 keys) the bytes.
//
// Design (FlashAttention-3's shape, written out in PTX; sm90.cuh):
// - Each block owns a 128-row q tile of one (batch, head): one producer
//   warpgroup (setmaxnreg down to 24) and two consumer warpgroups (up to
//   240), each consumer owning 64 rows.
// - TMA loads every operand through 4-D (D, S, H, B) tensor maps built from
//   the caller's strides, so the projection layout (B, S, H, D) and the
//   head-major one differ only in the map; rows past S and head-dim columns
//   past D arrive as zeros.  The head dim is padded to DP, a multiple of 64,
//   and every tile is a stack of 64-column blocks in the 128-byte swizzle
//   (40 -> 64, 80 -> 128, 160 -> 192); Q.K^T skips the k16 steps past D
//   (KS = ceil(D / 16) of DP / 16).  Q arrives once; K and V tiles go
//   through a 2-stage ring with full/empty mbarriers per stage, K and V
//   apart, so the next K can land while the current P.V still reads V.
//   ptxas compiles every path within the launch's 168 registers a thread
//   (setmaxnreg moves them at run time but does not raise that limit), so
//   the KV tiles hold 128 keys at DP = 64 and 64 above; DP = 192 spills 48
//   bytes, DP = 256 about 480.
// - The consumers prescale Q in shared memory (fp32 multiply, round to
//   bf16), then S = Q.K^T runs on wgmma m64nBKk16 with both operands
//   K-major in shared memory, and O += P.V on wgmma m64nNVk16 (NV = 16 KS
//   output columns, the zero ones past D skipped) with P from
//   registers (the S accumulator repacked to bf16 A fragments) and V read
//   from its row-major tile through the descriptor's transposed (MN-major)
//   mode: no transposed copy of V exists.
// - Per KV tile j a consumer issues S_j and P_{j-1}.V_{j-1} back to back and
//   computes the exponentials of S_j while P.V runs; the two consumers take
//   turns issuing their products (named barriers), so one's exp2s overlap
//   the other's tensor work.  Exponentials use ex2.approx.ftz on the SFU.
// - Epilogue: O/l to bf16 into the consumer's own rows of the Q tile (in the
//   swizzled layout), then a TMA store, which clips rows past Sq and columns
//   past D; the online variant writes the LSE row from registers.
// - Host side: the four tensor maps are encoded per launch and passed as
//   __grid_constant__ parameters.
//
// The transposed layout (TT = true, K9): q, k, v and o are head-dim-major,
// each (batch, head) slice D rows with the sequence contiguous (in memory
// padded to a multiple of 8 positions: TMA's 16-byte row stride).  The
// math is the online variant's; only the operand majors flip, and no
// transposed copy is made:
// - the maps are 4-D (S, D, H, B), D its own dimension, so rows past D
//   arrive as zeros (a flattened (B.H.D, S) view would load the next
//   head's rows); every tile is a stack of 64-position column blocks of
//   R = 16 KS head-dim rows: the k16 steps past D are not loaded at all;
// - S = Q.K^T reads both operands MN-major (the positions along the
//   128-byte rows, the contraction down them): Q's column block is the
//   consumer's 64 rows, K's the key tile;
// - O += P.V reads the V^T tile K-major (the keys along the rows), as
//   the natural layout reads K, with NV = R output columns;
// - the epilogue writes O^T (R rows by the consumer's 64 positions) over
//   its column block of the Q tile and TMA-stores it into (B, H, D, Sq).

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::pack_bf16;
using sm90::quad_max;
using sm90::quad_sum;
using sm90::swz;

typedef __nv_bfloat16 bf16;

constexpr int STAGES = 2;
constexpr int CB = 64;            // columns per swizzled column block
constexpr float CAP = 60.f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

// The block's shape for padded head dim DP and KS k16 steps of Q.K^T
// (ceil(D / 16): the zero columns past D are skipped).
template <int DP, int KS, bool TT>
struct Cfg {
  static_assert(DP % CB == 0 && KS * 16 <= DP, "bad head-dim padding");
  static constexpr int NWG = 2;  // consumer warpgroups
  static constexpr int BQ = 64 * NWG;                         // q rows
  static constexpr int NTHREADS = 128 * (NWG + 1);
  static constexpr int REGS = 240;  // per consumer thread
  // KV rows per tile: 128 at DP = 64, 64 above, where S, P and O together
  // would outgrow the registers (128 keys spill at DP = 128 and ran slower).
  static constexpr int BK = DP == 64 ? 128 : 64;
  // a tile's extent along the head dim: DP columns, or (TT) 16 KS rows
  static constexpr int W = TT ? 16 * KS : DP;
  static constexpr int Q_BYTES = BQ * W * 2;
  static constexpr int KV_BYTES = BK * W * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // full_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES)
                              + 1024;  // room to align the base
};

// S (64 x BK) = Q_w (64 x 16 KS) . K^T: KS k16 steps, both K-major; the Q
// tile has BQ rows.
template <int KS, int BQ, int BK>
__device__ __forceinline__ void gemm_qk(float (&s)[BK / 2], const uint8_t* qw,
                                        const uint8_t* kt) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = (ks % 4) * 32;  // k16 step inside a column block
    const uint64_t a = sm90::desc_sw128(qw + (ks / 4) * BQ * 128 + off, 16);
    const uint64_t b = sm90::desc_sw128(kt + (ks / 4) * BK * 128 + off, 16);
    sm90::WgmmaSS<BK>::run(s, a, b, ks > 0);
  }
}

// O (64 x DP) += P (64 x BK, registers) . V (BK x DP, row-major tile read
// MN-major): BK/16 k16 steps of 16 V rows (2048 bytes) each.
template <int DP, int BK>
__device__ __forceinline__ void gemm_pv(float (&o)[DP / 2],
                                        const uint32_t (&p)[BK / 16][4],
                                        const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::WgmmaRS<DP>::run(o, p[kk], sm90::desc_sw128(vt + kk * 16 * 128,
                                                      BK * 128));
}

// The transposed layout's products (TT): S (64 x BK) = Q_w . K^T with both
// operands MN-major (Q_w: the consumer's column block of R rows; K^T: BK/64
// column blocks of R rows), KS k16 steps of 16 rows (2048 bytes) each.
template <int KS, int BK>
__device__ __forceinline__ void gemm_qk_tt(float (&s)[BK / 2],
                                           const uint8_t* qw,
                                           const uint8_t* kt) {
  constexpr int R = 16 * KS;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    sm90::WgmmaSStt<BK>::run(s, sm90::desc_sw128(qw + ks * 2048, R * 128),
                             sm90::desc_sw128(kt + ks * 2048, R * 128),
                             ks > 0);
}

// O (64 x NV) += P (registers) . V, V read from the V^T tile (R = NV rows,
// BK/64 column blocks of keys) K-major.
template <int NV, int BK>
__device__ __forceinline__ void gemm_pv_tt(float (&o)[NV / 2],
                                           const uint32_t (&p)[BK / 16][4],
                                           const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::WgmmaRSk<NV>::run(
        o, p[kk], sm90::desc_sw128(vt + (kk / 4) * NV * 128 + (kk % 4) * 32,
                                   16));
}

struct Params {
  int H, Sq, Sk;
  float qscale;
  float* lse;  // (B, H, Sq) fp32, online only
};

template <int DP, int KS, bool ONLINE, bool TT>
__global__ void __launch_bounds__(Cfg<DP, KS, TT>::NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, Params prm) {
  using L = Cfg<DP, KS, TT>;
  static_assert(ONLINE || !TT, "the transposed layout is the online one");
  constexpr int BK = L::BK, BQ = L::BQ, NWG = L::NWG;
  constexpr int NV = 16 * KS;  // output columns computed (>= D)
  constexpr int NCB = DP / CB;
  constexpr int R = L::W;  // TT: head-dim rows of a column block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;  // the Q tile, then this block's O
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (prm.Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;  // < NWG: consumers; NWG: producer

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty_k + s, 4 * NWG);  // one per consumer warp
      sm90::mbar_init(empty_v + s, 4 * NWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread keeps the TMA loads in flight
    sm90::reg_dealloc<24>();
    if (threadIdx.x == NWG * 128) {
      sm90::mbar_expect_tx(full_q, L::Q_BYTES);
      if (TT) {
        for (int c = 0; c < BQ / CB; ++c)
          sm90::tma_load_4d(sq + c * R * 128, &tq, full_q, q0 + c * CB, 0, h,
                            b);
      } else {
        for (int c = 0; c < NCB; ++c)
          sm90::tma_load_4d(sq + c * BQ * 128, &tq, full_q, c * CB, q0, h, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        uint8_t* kt = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vt = smem + L::V_OFF + s * L::KV_BYTES;
        sm90::mbar_wait(empty_k + s, ph ^ 1);
        sm90::mbar_expect_tx(full_k + s, L::KV_BYTES);
        if (TT) {
          for (int c = 0; c < BK / CB; ++c)
            sm90::tma_load_4d(kt + c * R * 128, &tk, full_k + s,
                              j * BK + c * CB, 0, h, b);
        } else {
          for (int c = 0; c < NCB; ++c)
            sm90::tma_load_4d(kt + c * BK * 128, &tk, full_k + s, c * CB,
                              j * BK, h, b);
        }
        sm90::mbar_wait(empty_v + s, ph ^ 1);
        sm90::mbar_expect_tx(full_v + s, L::KV_BYTES);
        if (TT) {
          for (int c = 0; c < BK / CB; ++c)
            sm90::tma_load_4d(vt + c * R * 128, &tv, full_v + s,
                              j * BK + c * CB, 0, h, b);
        } else {
          for (int c = 0; c < NCB; ++c)
            sm90::tma_load_4d(vt + c * BK * 128, &tv, full_v + s, c * CB,
                              j * BK, h, b);
        }
      }
    }
  } else {
    // ---- consumers
    sm90::reg_alloc<L::REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const int wbar = 1 + wg;  // this consumer's own named barrier
    // turns to issue products, round robin over the consumers: each waits
    // on its own barrier and, once it has issued, opens the next one's
    const int my_turn = 1 + NWG + wg, next_turn = 1 + NWG + (wg + 1) % NWG;
    // this consumer's 64 rows: in each column block, or (TT) its own block
    uint8_t* qw = sq + wg * (TT ? R : 64) * 128;

    // Q: prescale by scale*log2e in fp32, round once to bf16
    sm90::mbar_wait(full_q, 0);
    for (int i = t; i < (TT ? R : NCB * 64) * 8; i += 128) {  // 16-byte chunks
      const int c = i / (64 * 8), r = (i / 8) % 64, ch = i % 8;
      uint4* p = reinterpret_cast<uint4*>(
          TT ? qw + i * 16 : qw + c * BQ * 128 + r * 128 + ch * 16);
      uint4 val = *p;
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = __float2bfloat16(__bfloat162float(e[k]) * prm.qscale);
      *p = val;
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(wbar, 128);

    float o[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
    float s[BK / 2];
    uint32_t p[BK / 16][4];
    float m0 = NEG_INF, m1 = NEG_INF;  // running max, rows g and g + 8
    float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums
    float a0 = 1.f, a1 = 1.f;          // pending rescale of O (online)
    const bool ragged = prm.Sk % BK != 0;

    // exponentials of S_j in place (and the row statistics)
    auto softmax = [&](int j) {
      if (ragged && j == nk - 1) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int col = j * BK + n * 8 + 2 * qd;
          if (col >= prm.Sk) s[4 * n] = s[4 * n + 2] = NEG_INF;
          if (col + 1 >= prm.Sk) s[4 * n + 1] = s[4 * n + 3] = NEG_INF;
        }
      }
      if (ONLINE) {
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
      } else {
        // masked keys hold -1e30: exp2 gives p = 0
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = ex2(fminf(s[i], CAP));
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          l0 += s[4 * n] + s[4 * n + 1];
          l1 += s[4 * n + 2] + s[4 * n + 3];
        }
      }
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
      if (ONLINE) {
#pragma unroll
        for (int n = 0; n < NV / 8; ++n) {
          o[4 * n] *= a0; o[4 * n + 1] *= a0;
          o[4 * n + 2] *= a1; o[4 * n + 3] *= a1;
        }
      }
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) sm90::mbar_arrive(bar);
    };
    auto k_tile = [&](int j) {
      return smem + L::K_OFF + (j % STAGES) * L::KV_BYTES;
    };
    auto v_tile = [&](int j) {
      return smem + L::V_OFF + (j % STAGES) * L::KV_BYTES;
    };
    auto qk = [&](const uint8_t* kt) {
      if constexpr (TT) gemm_qk_tt<KS, BK>(s, qw, kt);
      else gemm_qk<KS, BQ, BK>(s, qw, kt);
    };
    auto pv = [&](const uint8_t* vt) {
      if constexpr (TT) gemm_pv_tt<NV, BK>(o, p, vt);
      else gemm_pv<NV, BK>(o, p, vt);
    };

    if (wg == NWG - 1) sm90::bar_arrive(1 + NWG, 256);  // consumer 0 first

    // KV tile 0: S_0 alone
    sm90::mbar_wait(full_k, 0);
    sm90::bar_sync(my_turn, 256);
    sm90::wgmma_fence();
    qk(k_tile(0));
    sm90::wgmma_commit();
    sm90::fence_regs(s);
    sm90::bar_arrive(next_turn, 256);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    release(empty_k);
    softmax(0);
    pack();

    for (int j = 1; j < nk; ++j) {
      const uint32_t ph = (j / STAGES) & 1, pph = ((j - 1) / STAGES) & 1;
      sm90::mbar_wait(full_k + j % STAGES, ph);
      sm90::bar_sync(my_turn, 256);
      sm90::wgmma_fence();
      qk(k_tile(j));
      sm90::wgmma_commit();
      sm90::fence_regs(s);
      rescale();
      sm90::mbar_wait(full_v + (j - 1) % STAGES, pph);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      pv(v_tile(j - 1));
      sm90::wgmma_commit();
      sm90::fence_regs(o);
      sm90::bar_arrive(next_turn, 256);
      sm90::wgmma_wait<1>();  // S_j done, P_{j-1}.V_{j-1} may still run
      sm90::fence_regs(s);
      release(empty_k + j % STAGES);
      softmax(j);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(empty_v + (j - 1) % STAGES);
      pack();
    }

    // the last P.V
    rescale();
    sm90::mbar_wait(full_v + (nk - 1) % STAGES, ((nk - 1) / STAGES) & 1);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    pv(v_tile(nk - 1));
    sm90::wgmma_commit();
    sm90::fence_regs(o);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    release(empty_v + (nk - 1) % STAGES);
    if (wg == 0) sm90::bar_sync(my_turn, 256);  // the last one's last turn

    // epilogue: O / l -> bf16 into this consumer's rows of the Q tile, then
    // one TMA store per column block
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float i0 = 1.f / (ONLINE ? l0 : fmaxf(l0, 1e-37f));
    const float i1 = 1.f / (ONLINE ? l1 : fmaxf(l1, 1e-37f));
    const int r0 = warp * 16 + g;  // row within this consumer's 64
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) {
      const int col = n * 8 + 2 * qd;
      if constexpr (TT) {  // O^T: head-dim row col, position r0
        bf16* ot = reinterpret_cast<bf16*>(qw);
        ot[swz(col, r0, R) / 2] = __float2bfloat16(o[4 * n] * i0);
        ot[swz(col + 1, r0, R) / 2] = __float2bfloat16(o[4 * n + 1] * i0);
        ot[swz(col, r0 + 8, R) / 2] = __float2bfloat16(o[4 * n + 2] * i1);
        ot[swz(col + 1, r0 + 8, R) / 2] =
            __float2bfloat16(o[4 * n + 3] * i1);
      } else {
        *reinterpret_cast<uint32_t*>(qw + swz(r0, col, BQ)) =
            pack_bf16(o[4 * n] * i0, o[4 * n + 1] * i0);
        *reinterpret_cast<uint32_t*>(qw + swz(r0 + 8, col, BQ)) =
            pack_bf16(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(wbar, 128);
    if (t == 0 && q0 + wg * 64 < prm.Sq) {
      if (TT) {
        sm90::tma_store_4d(&to, qw, q0 + wg * 64, 0, h, b);
      } else {
        for (int c = 0; c < NCB; ++c)
          sm90::tma_store_4d(&to, qw + c * BQ * 128, c * CB, q0 + wg * 64, h,
                             b);
      }
      sm90::tma_store_commit_and_wait();
    }
    if (ONLINE && qd == 0) {
      const int row = q0 + wg * 64 + r0;
      float* lb = prm.lse + ((long long)b * prm.H + h) * prm.Sq;
      if (row < prm.Sq) lb[row] = m0 * LN2 + logf(l0);
      if (row + 8 < prm.Sq) lb[row + 8] = m1 * LN2 + logf(l1);
    }
  }
}


// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

using sm90::View;
using sm90::make_map;
using sm90::make_map_tt;

template <int DP, int KS, bool ONLINE, bool TT>
cudaError_t launch(const View& q, const View& k, const View& v, const View& o,
                   float* lse, int B, int H, int Sq, int Sk, int D,
                   float qscale, cudaStream_t stream) {
  using C = Cfg<DP, KS, TT>;
  CUtensorMap tq, tk, tv, to;
  const bool ok = TT ? make_map_tt(&tq, q, B, Sq, H, D, C::W)
                           && make_map_tt(&tk, k, B, Sk, H, D, C::W)
                           && make_map_tt(&tv, v, B, Sk, H, D, C::W)
                           && make_map_tt(&to, o, B, Sq, H, D, C::W)
                     : make_map(&tq, q, B, Sq, H, D, C::BQ)
                           && make_map(&tk, k, B, Sk, H, D, C::BK)
                           && make_map(&tv, v, B, Sk, H, D, C::BK)
                           && make_map(&to, o, B, Sq, H, D, 64);
  if (!ok) return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(
      flash_fwd_sm90_kernel<DP, KS, ONLINE, TT>, C::SMEM, raised);
  if (err != cudaSuccess) return err;
  const Params prm{H, Sq, Sk, qscale, lse};
  dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  flash_fwd_sm90_kernel<DP, KS, ONLINE, TT>
      <<<grid, C::NTHREADS, C::SMEM, stream>>>(tq, tk, tv, to, prm);
  return cudaGetLastError();
}

// The instantiations: the padded head dim, and the k16 steps of Q.K^T
// trimmed to the main path's head dims (40, 80, 160); others take all.
template <bool ONLINE, bool TT = false>
int dispatch(const View& q, const View& k, const View& v, const View& o,
             float* lse, int B, int H, int Sq, int Sk, int D, float qscale,
             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 || D % 8
      || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks = (D + 15) / 16;
#define SDBC_LAUNCH(DP, KS) \
  (int)launch<DP, KS, ONLINE, TT>(q, k, v, o, lse, B, H, Sq, Sk, D, qscale, \
                                  s)
  if (ks <= 3) return SDBC_LAUNCH(64, 3);
  if (ks <= 4) return SDBC_LAUNCH(64, 4);
  if (ks <= 5) return SDBC_LAUNCH(128, 5);
  if (ks <= 8) return SDBC_LAUNCH(128, 8);
  if (ks <= 10) return SDBC_LAUNCH(192, 10);
  if (ks <= 12) return SDBC_LAUNCH(192, 12);
  return SDBC_LAUNCH(256, 16);
#undef SDBC_LAUNCH
}

}  // namespace

// K1-K3, the fixed cap: q/k/v/o bf16 with (batch, seq, head) strides in
// elements (multiples of 8), a contiguous head dim, D <= 256 and a multiple
// of 8, 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int sdbc_flash_fixed(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Sq, int Sk, int D,
                                long long qsb, long long qss, long long qsh,
                                long long ksb, long long kss, long long ksh,
                                long long vsb, long long vss, long long vsh,
                                long long osb, long long oss, long long osh,
                                float qscale, void* stream) {
  return dispatch<false>(View{q, qsb, qss, qsh}, View{k, ksb, kss, ksh},
                         View{v, vsb, vss, vsh}, View{o, osb, oss, osh},
                         nullptr, B, H, Sq, Sk, D, qscale, stream);
}

// K5, the training forward for D <= 256: as sdbc_flash_fixed, with `st`
// holding (batch, head, seq) strides, three per tensor in argument order,
// and `lse` a contiguous (B, H, Sq) fp32 output.
extern "C" int sdbc_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int Sq,
                                   int Sk, int D, const long long* st,
                                   float qscale, void* stream) {
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  return dispatch<true>(view(q, 0), view(k, 1), view(v, 2), view(o, 3),
                        static_cast<float*>(lse), B, H, Sq, Sk, D, qscale,
                        stream);
}

// K9 for D <= 256: as sdbc_flash_fwd_sm90 over head-dim-major (batch, head,
// D, S) q/k/v/o, `st` holding (batch, head, head-dim row) strides, three
// per tensor; the sequence contiguous, every row 16-byte aligned with a
// stride that is a multiple of 8 (the output's too).
extern "C" int sdbc_flash_fwd_tt_sm90(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int H, int Sq, int Sk, int D,
                                      const long long* st, float qscale,
                                      void* stream) {
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  return dispatch<true, true>(view(q, 0), view(k, 1), view(v, 2), view(o, 3),
                              static_cast<float*>(lse), B, H, Sq, Sk, D,
                              qscale, stream);
}

extern "C" const char* sdbc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
