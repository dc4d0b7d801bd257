// Flash-attention backward for Hopper (sm_90a), bf16, on TMA-fed wgmma: the
// dq kernel and the dk/dv kernel of the training backward.
//
// Replaces the JAX package's Pallas kernels (via flash_bwd), for head dims
// up to 192 (wider ones run flash_bwd_wide_sm90.cu's kernels):
//   flash_bwd_dq_sm90_kernel  <- sdbc_tpu/ops/flash_attention_bwd.py _dq_kernel
//   flash_bwd_dkv_sm90_kernel <- sdbc_tpu/ops/flash_attention_bwd.py _dkv_kernel
//
// Math (as the TPU kernels), with the folds done by the caller as the JAX
// wrapper does them outside its kernels: qs = bf16(scale*q) and
// kl = bf16(log2e*k), each folded in fp32 and rounded once; lse2 = lse*log2e
// and delta = rowsum(dO*O) in fp32, zero-padded to a whole number of
// 128-row q tiles.  Then
//   p = exp2(qs.kl^T - lse2),  ds0 = bf16(p * (dO.V^T - delta)),
//   dq = dq_mul * sum ds0.kl (dq_mul = scale/log2e),
//   dk = sum ds0^T.qs,  dv = sum bf16(p)^T.dO.
// Keys past Sk are masked on the last KV tile of the dq kernel (p = 0:
// with zero-filled keys p would be exp2(-lse2), which overflows where lse2
// is far below 0).  q rows past Sq need no mask anywhere: their qs and dO
// arrive as zeros and their lse2 and delta are the zero pad, so p = 1 and
// ds0 = 0 and they add nothing to dk or dv; rows of an output past S are
// clipped by its TMA store.
//
// What bounds them on the H100: per score element the dq kernel costs 6*D
// tensor FLOPs and one exp2, the dk/dv kernel 8*D and one exp2.  At 989
// TFLOP/s of bf16 tensor math against ~3.9 T exp2/s, the dq kernel is bound
// by its exponentials at D = 40, the dk/dv kernel by the tensor cores; at
// 256 keys both by the bytes.
//
// Design (the forward's in flash_fwd_sm90.cu, with the backward's products;
// PTX helpers in sm90.cuh):
// - Warp-specialised blocks: one producer warpgroup whose one thread keeps
//   TMA loads in flight, and NWG consumer warpgroups of 64 rows each.  The
//   dq kernel keeps NWG*64 q rows of qs and dO resident and streams kl and
//   V tiles of BT keys through a 2-stage ring (full/empty mbarriers);
//   the dk/dv kernel keeps NWG*64 rows of kl and V resident and streams qs
//   and dO tiles of BT q rows, each with its lse2 and delta slices (a 1-D
//   bulk copy on the same barrier).  The JAX grids' partition is kept: no
//   atomics, each output element is written by one block.
// - Every operand arrives ready for wgmma through 4-D (D, S, H, B) tensor
//   maps built from the caller's strides (the projection layout and the
//   head-major one differ only in the map), 128-byte swizzle, head dim
//   padded to DP (40 -> 64, 80 -> 128, 160 -> 192).  No transposed copy
//   exists: the products over the sequence read their B operand MN-major
//   from the row-major tile, as the forward reads V.
//     dq:    S = qs.kl^T and dP = dO.V^T (both K-major), dq += ds0.kl with
//            ds0 repacked from the accumulator registers to bf16 A
//            fragments and kl read MN-major;
//     dk/dv: S^T = kl.qs^T and dP^T = V.dO^T (K-major); dv += bf16(p^T).dO
//            and dk += ds0^T.qs (A from registers, the streamed dO and qs
//            read MN-major).  lse2 and delta index the columns of S^T; each
//            thread reads its columns from the slices in shared memory.
//   The k16 steps and output columns past D are skipped (KS = ceil(D/16)).
// - Per streamed tile a consumer issues its two score products back to
//   back, computes the exp2s (ex2.approx.ftz on the SFU) of the first while
//   the second runs, then issues the output products.  With two consumers
//   the score products take turns (named barriers), so one's exponentials
//   overlap the other's tensor work.
// - Registers: ptxas compiles a 384-thread block within 168 registers a
//   thread, whatever setmaxnreg asks for.  The score accumulators (BT per
//   thread for the two) and the outputs (NV/2 each) must fit, so the dk/dv
//   kernel, which holds dk and dv together, runs two consumers up to
//   NV = 80 and one (a 256-thread block, 255 registers) above; so does the
//   dq kernel above NV = 128, where one consumer also ran faster at 256
//   keys (twice the blocks).  Streamed tiles hold 64 rows, 32 for dk/dv at
//   NV = 192 (64 spill there).
// - Epilogue: the outputs to bf16 in swizzled shared memory (over the
//   consumer's own rows of a resident tile), then a TMA store, which clips
//   rows past S and columns past D.

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::pack_bf16;
using sm90::swz;

typedef __nv_bfloat16 bf16;

constexpr int STAGES = 2;
constexpr int CB = 64;  // columns per swizzled column block
constexpr float NEG_INF = -1e30f;

// The block's shape for padded head dim DP, KS k16 steps of the score
// products (ceil(D / 16)) and the kernel (DKV: dk/dv, else dq).
template <int DP, int KS, bool DKV>
struct Cfg {
  static_assert(DP % CB == 0 && KS * 16 <= DP, "bad head-dim padding");
  static constexpr int NV = 16 * KS;  // output columns computed (>= D)
  static constexpr int NWG = NV > (DKV ? 80 : 128) ? 1 : 2;  // consumers
  static constexpr int BT = DKV && NV > 160 ? 32 : 64;       // streamed rows
  static constexpr int BR = 64 * NWG;                 // resident rows
  static constexpr int NTHREADS = 128 * (NWG + 1);
  static constexpr int RES_BYTES = BR * DP * 2;  // one resident tile
  static constexpr int ST_BYTES = BT * DP * 2;   // one streamed tile
  static constexpr int VEC_BYTES = DKV ? 2 * BT * 4 : 0;  // lse2, delta
  static constexpr int S0_OFF = 2 * RES_BYTES;  // streamed kl (dq) / qs
  static constexpr int S1_OFF = S0_OFF + STAGES * ST_BYTES;  // V / dO
  static constexpr int VEC_OFF = S1_OFF + STAGES * ST_BYTES;
  static constexpr int BAR_OFF = VEC_OFF + STAGES * VEC_BYTES;
  // full_r, full[S], empty[S]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int STEP_BYTES = 2 * ST_BYTES + VEC_BYTES;
};

// C (64 x N) = A_w (64 x 16 KS) . B^T: KS k16 steps, both K-major; A is 64
// rows of a tile of RA rows, B a tile of N rows.
template <int KS, int RA, int N>
__device__ __forceinline__ void gemm_ss(float (&c)[N / 2], const uint8_t* aw,
                                        const uint8_t* bt) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = (ks % 4) * 32;  // k16 step inside a column block
    const uint64_t a = sm90::desc_sw128(aw + (ks / 4) * RA * 128 + off, 16);
    const uint64_t b = sm90::desc_sw128(bt + (ks / 4) * N * 128 + off, 16);
    sm90::WgmmaSS<N>::run(c, a, b, ks > 0);
  }
}

// C (64 x NV) += X (64 x K, bf16 A fragments) . T (K x NV, the row-major
// tile of K rows read MN-major): K/16 k16 steps of 16 rows (2048 bytes).
template <int NV, int K>
__device__ __forceinline__ void gemm_rs(float (&c)[NV / 2],
                                        const uint32_t (&x)[K / 16][4],
                                        const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    sm90::WgmmaRS<NV>::run(c, x[kk], sm90::desc_sw128(tile + kk * 16 * 128,
                                                      K * 128));
}

// bf16 A fragments of a (64 x K) accumulator: chunks 2kk (a0: row g, a1:
// row g + 8) and 2kk + 1 (a2, a3).
template <int K>
__device__ __forceinline__ void pack_frags(uint32_t (&x)[K / 16][4],
                                           const float (&c)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    x[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    x[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    x[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    x[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// A (64 x NV) accumulator times `mul` to bf16 at this thread's places in a
// consumer's 64 rows of a swizzled tile of `rows` rows.
template <int NV>
__device__ __forceinline__ void stage_out(uint8_t* w, int rows,
                                          const float (&c)[NV / 2], float mul,
                                          int r0, int qd) {
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const int col = n * 8 + 2 * qd;
    *reinterpret_cast<uint32_t*>(w + swz(r0, col, rows)) =
        pack_bf16(c[4 * n] * mul, c[4 * n + 1] * mul);
    *reinterpret_cast<uint32_t*>(w + swz(r0 + 8, col, rows)) =
        pack_bf16(c[4 * n + 2] * mul, c[4 * n + 3] * mul);
  }
}

struct Params {
  int H, Sq, Sk, sq_pad;
  float dq_mul;
  const float* lse2;   // (B, H, sq_pad) fp32, zero past Sq
  const float* delta;  // (B, H, sq_pad) fp32, zero past Sq
};

// The producer's one thread: the two resident tiles (rows r0.. of ta, tb)
// on full_r, then per step j the two streamed tiles (rows j*BT.. of sa, sb)
// and, for dk/dv, the lse2/delta slices into stage j % STAGES.
template <class L>
__device__ __forceinline__ void produce(
    uint8_t* smem, uint64_t* full_r, uint64_t* full, uint64_t* empty,
    const CUtensorMap* ta, const CUtensorMap* tb, const CUtensorMap* sa,
    const CUtensorMap* sb, const float* lse2, const float* delta, int r0,
    int steps, int h, int b) {
  constexpr int NCB = L::RES_BYTES / (L::BR * 128);
  sm90::mbar_expect_tx(full_r, 2 * L::RES_BYTES);
  for (int c = 0; c < NCB; ++c) {
    sm90::tma_load_4d(smem + c * L::BR * 128, ta, full_r, c * CB, r0, h, b);
    sm90::tma_load_4d(smem + L::RES_BYTES + c * L::BR * 128, tb, full_r,
                      c * CB, r0, h, b);
  }
  for (int j = 0; j < steps; ++j) {
    const int s = j % STAGES;
    uint8_t* a = smem + L::S0_OFF + s * L::ST_BYTES;
    uint8_t* bt = smem + L::S1_OFF + s * L::ST_BYTES;
    sm90::mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);
    sm90::mbar_expect_tx(full + s, L::STEP_BYTES);
    for (int c = 0; c < NCB; ++c) {
      sm90::tma_load_4d(a + c * L::BT * 128, sa, full + s, c * CB, j * L::BT,
                        h, b);
      sm90::tma_load_4d(bt + c * L::BT * 128, sb, full + s, c * CB,
                        j * L::BT, h, b);
    }
    if (L::VEC_BYTES) {
      float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF
                                            + s * L::VEC_BYTES);
      sm90::bulk_load(vec, lse2 + j * L::BT, L::BT * 4, full + s);
      sm90::bulk_load(vec + L::BT, delta + j * L::BT, L::BT * 4, full + s);
    }
  }
}

// Shared memory of a block, its barriers initialised by thread 0.
template <class L>
__device__ __forceinline__ uint8_t* setup(uint8_t* raw, uint64_t*& full_r,
                                          uint64_t*& full, uint64_t*& empty) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  full_r = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  full = full_r + 1;
  empty = full + STAGES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(full_r, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4 * L::NWG);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return smem;
}

// ---------------------------------------------------------------------------
// K6a: dq for NWG*64 q rows, streaming kl and V tiles

template <int DP, int KS>
__global__ void __launch_bounds__(Cfg<DP, KS, false>::NTHREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tqs,
                         const __grid_constant__ CUtensorMap tkl,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tdq,
                         Params prm) {
  using L = Cfg<DP, KS, false>;
  constexpr int BT = L::BT, BR = L::BR, NWG = L::NWG, NV = L::NV;
  constexpr int NCB = DP / CB;
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full_r, *full, *empty;
  uint8_t* smem = setup<L>(smem_raw, full_r, full, empty);

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int nk = (prm.Sk + BT - 1) / BT;
  const int wg = threadIdx.x / 128;  // < NWG: consumers; NWG: producer

  if (wg == NWG) {
    if (NWG > 1) sm90::reg_dealloc<24>();
    if (threadIdx.x == NWG * 128)
      produce<L>(smem, full_r, full, empty, &tqs, &tdo, &tkl, &tv, nullptr,
                 nullptr, q0, nk, h, b);
    return;
  }
  if (NWG > 1) sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int my_turn = 1 + NWG + wg, next_turn = 1 + NWG + (wg + 1) % NWG;
  uint8_t* qw = smem + wg * 64 * 128;  // this consumer's rows of qs, then dq
  const uint8_t* dow = smem + L::RES_BYTES + wg * 64 * 128;
  const int r0 = warp * 16 + g;  // row within this consumer's 64
  const long long vrow = ((long long)b * prm.H + h) * prm.sq_pad + q0
                         + wg * 64 + r0;
  const float lse0 = prm.lse2[vrow], lse1 = prm.lse2[vrow + 8];
  const float dl0 = prm.delta[vrow], dl1 = prm.delta[vrow + 8];
  const bool ragged = prm.Sk % BT != 0;

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  float s[BT / 2], dp[BT / 2];
  uint32_t ds[BT / 16][4];

  if (NWG > 1 && wg == NWG - 1) sm90::bar_arrive(1 + NWG, 256);  // 0 first
  sm90::mbar_wait(full_r, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j % STAGES;
    const uint8_t* kt = smem + L::S0_OFF + st * L::ST_BYTES;
    const uint8_t* vt = smem + L::S1_OFF + st * L::ST_BYTES;
    sm90::mbar_wait(full + st, (j / STAGES) & 1);
    if (NWG > 1) sm90::bar_sync(my_turn, 256);
    sm90::wgmma_fence();
    gemm_ss<KS, BR, BT>(s, qw, kt);
    sm90::wgmma_commit();
    gemm_ss<KS, BR, BT>(dp, dow, vt);
    sm90::wgmma_commit();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (NWG > 1) sm90::bar_arrive(next_turn, 256);
    sm90::wgmma_wait<1>();  // S done, dP may still run
    sm90::fence_regs(s);
    if (ragged && j == nk - 1) {
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
        const int col = j * BT + n * 8 + 2 * qd;
        if (col >= prm.Sk) s[4 * n] = s[4 * n + 2] = NEG_INF;
        if (col + 1 >= prm.Sk) s[4 * n + 1] = s[4 * n + 3] = NEG_INF;
      }
    }
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      s[4 * n] = ex2(s[4 * n] - lse0);
      s[4 * n + 1] = ex2(s[4 * n + 1] - lse0);
      s[4 * n + 2] = ex2(s[4 * n + 2] - lse1);
      s[4 * n + 3] = ex2(s[4 * n + 3] - lse1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      dp[4 * n] = s[4 * n] * (dp[4 * n] - dl0);
      dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - dl0);
      dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - dl1);
      dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - dl1);
    }
    pack_frags<BT>(ds, dp);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    gemm_rs<NV, BT>(acc, ds, kt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(empty + st);
  }
  if (NWG > 1 && wg == 0) sm90::bar_sync(my_turn, 256);  // the last turn

  stage_out<NV>(qw, BR, acc, prm.dq_mul, r0, qd);
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + wg, 128);
  if (t == 0 && q0 + wg * 64 < prm.Sq) {
    for (int c = 0; c < NCB; ++c)
      sm90::tma_store_4d(&tdq, qw + c * BR * 128, c * CB, q0 + wg * 64, h, b);
    sm90::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// K6b: dk, dv for NWG*64 KV rows, streaming qs and dO tiles.  Each consumer
// computes the transposed products S^T = kl.qs^T and dP^T = V.dO^T for its
// 64 KV rows, so p^T and ds0^T land in A-fragment layout directly.

template <int DP, int KS>
__global__ void __launch_bounds__(Cfg<DP, KS, true>::NTHREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tqs,
                          const __grid_constant__ CUtensorMap tkl,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdk,
                          const __grid_constant__ CUtensorMap tdv,
                          Params prm) {
  using L = Cfg<DP, KS, true>;
  constexpr int BT = L::BT, BR = L::BR, NWG = L::NWG, NV = L::NV;
  constexpr int NCB = DP / CB;
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full_r, *full, *empty;
  uint8_t* smem = setup<L>(smem_raw, full_r, full, empty);

  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int nq = (prm.Sq + BT - 1) / BT;
  const int wg = threadIdx.x / 128;
  const long long vbase = ((long long)b * prm.H + h) * prm.sq_pad;

  if (wg == NWG) {
    if (NWG > 1) sm90::reg_dealloc<24>();
    if (threadIdx.x == NWG * 128)
      produce<L>(smem, full_r, full, empty, &tkl, &tv, &tqs, &tdo,
                 prm.lse2 + vbase, prm.delta + vbase, k0, nq, h, b);
    return;
  }
  if (NWG > 1) sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int my_turn = 1 + NWG + wg, next_turn = 1 + NWG + (wg + 1) % NWG;
  uint8_t* kw = smem + wg * 64 * 128;                   // kl, then dk
  uint8_t* vw = smem + L::RES_BYTES + wg * 64 * 128;    // V, then dv

  float dk[NV / 2], dv[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[BT / 2], dp[BT / 2];
  uint32_t pf[BT / 16][4], dsf[BT / 16][4];

  if (NWG > 1 && wg == NWG - 1) sm90::bar_arrive(1 + NWG, 256);
  sm90::mbar_wait(full_r, 0);
  for (int i = 0; i < nq; ++i) {
    const int st = i % STAGES;
    const uint8_t* qt = smem + L::S0_OFF + st * L::ST_BYTES;
    const uint8_t* dot = smem + L::S1_OFF + st * L::ST_BYTES;
    const float* lv = reinterpret_cast<const float*>(smem + L::VEC_OFF
                                                     + st * L::VEC_BYTES);
    const float* dlv = lv + BT;
    sm90::mbar_wait(full + st, (i / STAGES) & 1);
    if (NWG > 1) sm90::bar_sync(my_turn, 256);
    sm90::wgmma_fence();
    gemm_ss<KS, BR, BT>(s, kw, qt);
    sm90::wgmma_commit();
    gemm_ss<KS, BR, BT>(dp, vw, dot);
    sm90::wgmma_commit();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (NWG > 1) sm90::bar_arrive(next_turn, 256);
    sm90::wgmma_wait<1>();  // S^T done, dP^T may still run
    sm90::fence_regs(s);
    // p^T: column c of S^T is q row c of the tile
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lv + n * 8 + 2 * qd);
      s[4 * n] = ex2(s[4 * n] - l.x);
      s[4 * n + 1] = ex2(s[4 * n + 1] - l.y);
      s[4 * n + 2] = ex2(s[4 * n + 2] - l.x);
      s[4 * n + 3] = ex2(s[4 * n + 3] - l.y);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(dlv + n * 8 + 2 * qd);
      dp[4 * n] = s[4 * n] * (dp[4 * n] - d.x);
      dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - d.y);
      dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - d.x);
      dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - d.y);
    }
    pack_frags<BT>(pf, s);  // packed late: p^T, dP^T, dk, dv peak together
    pack_frags<BT>(dsf, dp);
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::wgmma_fence();
    gemm_rs<NV, BT>(dv, pf, dot);
    gemm_rs<NV, BT>(dk, dsf, qt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    if (lane == 0) sm90::mbar_arrive(empty + st);
  }
  if (NWG > 1 && wg == 0) sm90::bar_sync(my_turn, 256);

  const int r0 = warp * 16 + g;
  stage_out<NV>(kw, BR, dk, 1.f, r0, qd);
  stage_out<NV>(vw, BR, dv, 1.f, r0, qd);
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + wg, 128);
  if (t == 0 && k0 + wg * 64 < prm.Sk) {
    for (int c = 0; c < NCB; ++c) {
      sm90::tma_store_4d(&tdk, kw + c * BR * 128, c * CB, k0 + wg * 64, h, b);
      sm90::tma_store_4d(&tdv, vw + c * BR * 128, c * CB, k0 + wg * 64, h, b);
    }
    sm90::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

using sm90::View;
using sm90::make_map;

struct Args {
  View qs, kl, v, dout, dq, dk, dv;
  const float *lse2, *delta;
  int B, H, Sq, Sk, D, sq_pad;
  float dq_mul;
  cudaStream_t stream;
};

template <int DP, int KS>
cudaError_t launch_dq(const Args& a) {
  using C = Cfg<DP, KS, false>;
  CUtensorMap tqs, tkl, tv, tdo, tdq;
  if (!make_map(&tqs, a.qs, a.B, a.Sq, a.H, a.D, C::BR)
      || !make_map(&tdo, a.dout, a.B, a.Sq, a.H, a.D, C::BR)
      || !make_map(&tkl, a.kl, a.B, a.Sk, a.H, a.D, C::BT)
      || !make_map(&tv, a.v, a.B, a.Sk, a.H, a.D, C::BT)
      || !make_map(&tdq, a.dq, a.B, a.Sq, a.H, a.D, 64))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_bwd_dq_sm90_kernel<DP, KS>,
                                     C::SMEM, raised);
  if (err != cudaSuccess) return err;
  const Params prm{a.H, a.Sq, a.Sk, a.sq_pad, a.dq_mul, a.lse2, a.delta};
  dim3 grid((a.Sq + C::BR - 1) / C::BR, a.H, a.B);
  flash_bwd_dq_sm90_kernel<DP, KS><<<grid, C::NTHREADS, C::SMEM, a.stream>>>(
      tqs, tkl, tv, tdo, tdq, prm);
  return cudaGetLastError();
}

template <int DP, int KS>
cudaError_t launch_dkv(const Args& a) {
  using C = Cfg<DP, KS, true>;
  CUtensorMap tqs, tkl, tv, tdo, tdk, tdv;
  if (!make_map(&tqs, a.qs, a.B, a.Sq, a.H, a.D, C::BT)
      || !make_map(&tdo, a.dout, a.B, a.Sq, a.H, a.D, C::BT)
      || !make_map(&tkl, a.kl, a.B, a.Sk, a.H, a.D, C::BR)
      || !make_map(&tv, a.v, a.B, a.Sk, a.H, a.D, C::BR)
      || !make_map(&tdk, a.dk, a.B, a.Sk, a.H, a.D, 64)
      || !make_map(&tdv, a.dv, a.B, a.Sk, a.H, a.D, 64))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_bwd_dkv_sm90_kernel<DP, KS>,
                                     C::SMEM, raised);
  if (err != cudaSuccess) return err;
  const Params prm{a.H, a.Sq, a.Sk, a.sq_pad, 1.f, a.lse2, a.delta};
  dim3 grid((a.Sk + C::BR - 1) / C::BR, a.H, a.B);
  flash_bwd_dkv_sm90_kernel<DP, KS><<<grid, C::NTHREADS, C::SMEM, a.stream>>>(
      tqs, tkl, tv, tdo, tdk, tdv, prm);
  return cudaGetLastError();
}

// The instantiations: the padded head dim, and the k16 steps trimmed to the
// main path's head dims (40, 80, 160); others take all.  sq_pad must be a
// multiple of 128 covering Sq.
template <bool DKV>
int dispatch(const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.D <= 0
      || a.D > 192 || a.D % 8 || a.B > 65535 || a.H > 65535
      || a.sq_pad % 128 || a.sq_pad < a.Sq)
    return (int)cudaErrorInvalidValue;
  const int ks = (a.D + 15) / 16;
#define SDBC_LAUNCH(DP, KS) \
  (int)(DKV ? launch_dkv<DP, KS>(a) : launch_dq<DP, KS>(a))
  if (ks <= 3) return SDBC_LAUNCH(64, 3);
  if (ks <= 4) return SDBC_LAUNCH(64, 4);
  if (ks <= 5) return SDBC_LAUNCH(128, 5);
  if (ks <= 8) return SDBC_LAUNCH(128, 8);
  if (ks <= 10) return SDBC_LAUNCH(192, 10);
  return SDBC_LAUNCH(192, 12);
#undef SDBC_LAUNCH
}

Args args(const void* qs, const void* kl, const void* v, const void* dout,
          const void* lse2, const void* delta, int B, int H, int Sq, int Sk,
          int D, int sq_pad, const long long* st, void* stream) {
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  Args a{};
  a.qs = view(qs, 0);
  a.kl = view(kl, 1);
  a.v = view(v, 2);
  a.dout = view(dout, 3);
  a.lse2 = static_cast<const float*>(lse2);
  a.delta = static_cast<const float*>(delta);
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D, a.sq_pad = sq_pad;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// K6 for D <= 192, a multiple of 8.  qs, kl, v, dout and the outputs are
// bf16 with (batch, head, seq) strides in elements (`st`, three per tensor
// in argument order; multiples of 8), a contiguous head dim, 16-byte
// aligned; lse2 and delta are contiguous (B, H, sq_pad) fp32, zero past
// Sq, with sq_pad a multiple of 128.  Each returns cudaGetLastError() after
// its launch.
extern "C" int sdbc_flash_bwd_dq_sm90(const void* qs, const void* kl,
                                      const void* v, const void* dout,
                                      const void* lse2, const void* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, int sq_pad, const long long* st,
                                      float dq_mul, void* stream) {
  Args a = args(qs, kl, v, dout, lse2, delta, B, H, Sq, Sk, D, sq_pad, st,
                stream);
  a.dq = View{dq, st[12], st[14], st[13]};
  a.dq_mul = dq_mul;
  return dispatch<false>(a);
}

extern "C" int sdbc_flash_bwd_dkv_sm90(const void* qs, const void* kl,
                                       const void* v, const void* dout,
                                       const void* lse2, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int sq_pad,
                                       const long long* st, void* stream) {
  Args a = args(qs, kl, v, dout, lse2, delta, B, H, Sq, Sk, D, sq_pad, st,
                stream);
  a.dk = View{dk, st[12], st[14], st[13]};
  a.dv = View{dv, st[15], st[17], st[16]};
  return dispatch<true>(a);
}
