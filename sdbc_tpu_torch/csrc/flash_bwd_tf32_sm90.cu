// Flash-attention backward in fp32 for Hopper (sm_90a) on TMA-fed tf32
// wgmma, each product split in three ("3xTF32"): a split pre-pass, the dq
// kernel and the dk/dv kernel, for fp32 q/k/v with a head dim that is a
// multiple of 8, up to 160 (the bf16 calls go to flash_bwd_sm90.cu).
//
// Replaces, for those calls, the JAX package's Pallas kernels (which take
// any dtype):
//   flash_bwd_dq_tf32_sm90_kernel  <- sdbc_tpu/ops/flash_attention_bwd.py
//                                     _dq_kernel
//   flash_bwd_dkv_tf32_sm90_kernel <- sdbc_tpu/ops/flash_attention_bwd.py
//                                     _dkv_kernel
// and, for the same calls, the CUDA-core flash_simt_dq_kernel and
// flash_simt_dkv_kernel of flash_simt.cu, which keep the head dims that are
// not a multiple of 8 or lie above 160.
//
// Math: flash_attention_bwd.flash_bwd_prepared_ref in fp32.  The pre-pass
// folds qs = scale*q and kl = log2e*k, one fp32 multiply each (the wrapper's
// prepare() folds in torch for the other kernels); lse2 = lse*log2e and
// delta = rowsum(dO*O) come from the wrapper, zero-padded to a whole number
// of 128-row q tiles.  Then p = exp2(qs.kl^T - lse2), ds0 = p*(dO.V^T -
// delta), dq = dq_mul * sum ds0.kl (dq_mul = scale/log2e), dk = sum
// ds0^T.qs, dv = sum p^T.dO.  Each product a.b of fp32 operands is
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with x_hi = tf32(x), x_lo = tf32(x -
// x_hi) (to nearest, ties away), each term exact in fp32 and summed in the
// fp32 accumulator (~2^-21 of |a|.|b| lost, as in flash_fwd_tf32_sm90.cu).
// Keys past Sk are masked on the dq kernel's last key tile (p = 0); q rows
// past Sq arrive as zeros against the zero pad of lse2 and delta (p = 1,
// ds0 = 0), so they add nothing to dk and dv.
//
// What bounds them on the H100: per score the dq kernel does 3 x 6*D
// tensor FLOPs at 495 TFLOP/s (tf32) and one exp2, the dk/dv kernel 3 x 8*D
// and one exp2.  The FFMA kernels they replace did 6*D and 8*D FLOPs a
// score at 67 TFLOP/s, 2.5x this bound.
//
// Design (flash_bwd_sm90.cu's grid partition, flash_fwd_tf32_sm90.cu's
// products, sm90.cuh's PTX):
// - tf32 wgmma reads both operands K-major, with no transposed read.  The
//   products over the head dim (S = qs.kl^T and dP = dO.V^T in the dq
//   kernel, S^T = kl.qs^T and dP^T = V.dO^T in the dk/dv kernel) read the
//   natural (S, D) rows; the three over a sequence need it contiguous:
//   kl^T for dq += ds0.kl, qs^T and dO^T for dk += ds0^T.qs and dv +=
//   p^T.dO.  The pre-pass (split_bwd_kernel, one block a 32-row tile of
//   the q side or the key side) writes every operand once a call as hi and
//   lo parts into a torch.empty scratch: qs, dO, kl, V as (S, D) rows and
//   qs^T, dO^T, kl^T as (D, Sp) rows (Sp = S rounded up to 8, zero past
//   S).  Within each group of 8 positions of a transposed operand,
//   position c holds row pi(c) = (c % 4) * 2 + c / 4: the accumulator holds
//   columns 2t and 2t + 1 of each 8 (t = lane % 4) where the tf32 A
//   fragment takes t and t + 4, so ds0 and p (p^T and ds0^T in the dk/dv
//   kernel, whose S^T/dP^T accumulators index the q rows by column) go from
//   the accumulator registers to the A registers with no shuffle.
// - Grids as the JAX kernels': the dq kernel owns BR = 64 NWG q rows and
//   streams the keys, the dk/dv kernel owns BR key rows and streams the q
//   rows; each output element is written by one block (no atomics, the
//   same bits every run).  A producer warpgroup, one thread of which keeps
//   the TMA loads in flight, and NWG consumer warpgroups of 64 rows.  The
//   resident pair (qs and dO, or kl and V; hi and lo) arrives once; the
//   streamed operands of each step (kl, V, kl^T; or qs, dO, qs^T, dO^T)
//   go through one ring of NS slots, each slot one operand's hi and lo
//   tile, released as soon as its products are done.  With NWG = 2 the
//   two consumers' score products take turns (named barriers), so one's
//   exponentials overlap the other's tensor work.
// - Every tile is a stack of 16-column (64-byte) blocks in the 64-byte
//   swizzle (wgmma descriptor layout type 2, SBO 512; a k8 step is half a
//   row), so a head dim of 40 pads to 48 columns, not 64; rows and
//   columns past the tensors arrive as zeros (TMA's fill).
// - lse2 and delta: the dq kernel reads its rows' values once; the dk/dv
//   kernel, whose S^T columns are q rows, reads each step's from global
//   memory (L2) right after issuing the score products.
// - Epilogue: the fp32 accumulators stored from registers, 8 bytes a
//   thread, rows past S and columns past D dropped.
// - Per instantiation (NV >= D, the main path's 40, 80 and 160 exactly;
//   shared memory of the 227 KB: resident pair, ring):
//     dq   NV 40:  NWG 2, 64 keys a step,  5 slots (96 + 120 KB)
//     dq   NV 80:  NWG 1, 32 keys a step,  7 slots (80 + 140 KB)
//     dq   NV 160: NWG 1, 16 keys a step,  3 slots (160 + 60 KB)
//     dkv  NV 40:  NWG 2, 32 q rows a step, 8 slots (96 + 96 KB)
//     dkv  NV 80:  NWG 1, 32 q rows a step, 7 slots (80 + 140 KB)
//     dkv  NV 160: NWG 1, 16 q rows a step, 3 slots (160 + 60 KB)
//   Registers: the score accumulators and their lo parts (2 BT a thread)
//   and the outputs (NV / 2 each) under ptxas's 168 of a 384-thread block
//   (NWG 2) or 255 of a 256-thread one.

#include "sm90.cuh"

namespace {

using sm90::ex2;

constexpr int CB = 16;  // fp32 columns of a 64-byte swizzled column block
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100
constexpr float NEG_INF = -1e30f;
constexpr int MAX_D = 160;

__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t u32(float x) { return __float_as_uint(x); }

// x rounded to tf32 to nearest, ties away from zero, as an fp32 word with
// the low 13 mantissa bits zero: half a tf32 ulp added to the magnitude
// bits.  cvt.rna.tf32.f32's bits for every finite x (sm90::tf32_rna), in
// two integer operations where ptxas adds compares and selects for cvt's
// special cases (the dk/dv kernel splits two values a score).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The block's shape for NV output columns (NV / 8 k8 steps of the products
// over the head dim), dq (DKV false) or dk/dv.
template <int NV, bool DKV>
struct Cfg {
  static_assert(NV % 8 == 0 && NV <= MAX_D, "bad head dim");
  static constexpr int NVC = NV;
  static constexpr int DP = (NV + CB - 1) / CB * CB;  // natural columns
  static constexpr int KS = NV / 8;
  static constexpr int NWG = NV <= 40 ? 2 : 1;  // consumer warpgroups
  // streamed rows a step: keys (dq) or q rows (dk/dv)
  static constexpr int BT = NV <= 40 ? (DKV ? 32 : 64) : NV <= 80 ? 32 : 16;
  static constexpr int BR = 64 * NWG;  // resident rows
  static constexpr int NTHREADS = 128 * (NWG + 1);
  static constexpr int OPS = DKV ? 4 : 3;  // streamed operands a step
  static constexpr int RES_PART = BR * DP * 4;  // one part of one operand
  static constexpr int NAT_PART = BT * DP * 4;
  static constexpr int TR_PART = NV * BT * 4;
  static constexpr int SLOT_PART = cmax(NAT_PART, TR_PART);  // hi; lo next
  static constexpr int SLOT = 2 * SLOT_PART;
  static constexpr int SLOT_OFF = 4 * RES_PART;  // two operands, hi and lo
  static constexpr int NS = cmin(8, (SMEM_MAX - 1024 - 256 - SLOT_OFF)
                                        / SLOT);  // ring slots
  static constexpr int BAR_OFF = SLOT_OFF + NS * SLOT;
  // full_r, full[NS], empty[NS]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS)
                              + 1024;  // room to align the base
  static_assert(NS >= 3, "ring too short");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(RES_PART % 512 == 0 && SLOT_PART % 512 == 0
                    && NAT_PART % 512 == 0 && TR_PART % 512 == 0,
                "tiles on 512-byte boundaries (the 64-byte swizzle)");
};

// C (64 x N) (=) A . B^T over KS k8 steps of the head dim, three tf32
// products a step (lo.hi, hi.lo, hi.hi): A the consumer's 64 rows of a
// natural tile of RA rows (a: its hi part, lo `a_lo` bytes on), B a
// natural tile of N rows (b, lo `b_lo` bytes on).
template <int KS, int RA, int N>
__device__ __forceinline__ void gemm_nat(float (&c)[N / 2], const uint8_t* a,
                                         int a_lo, const uint8_t* b,
                                         int b_lo) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int ao = (ks / 2) * RA * 64 + (ks % 2) * 32;
    const int bo = (ks / 2) * N * 64 + (ks % 2) * 32;
    const uint64_t ah = sm90::desc_sw64(a + ao, 16);
    const uint64_t al = sm90::desc_sw64(a + a_lo + ao, 16);
    const uint64_t bh = sm90::desc_sw64(b + bo, 16);
    const uint64_t bl = sm90::desc_sw64(b + b_lo + bo, 16);
    sm90::WgmmaTF32SS<N>::run(c, al, bh, ks > 0);
    sm90::WgmmaTF32SS<N>::run(c, ah, bl, 1);
    sm90::WgmmaTF32SS<N>::run(c, ah, bh, 1);
  }
}

// C (64 x NV) += X (64 x BT) . T, X from the registers of a 64 x BT
// accumulator (xh: the hi parts' bits in place, xl: the lo parts), T read
// from a transposed tile (NV rows of BT positions, t: its hi part, lo
// `t_lo` bytes on; positions permuted by pi within each 8).  k8 step kk
// takes accumulator chunk kk: a0 = (g, col 2t) = x[4kk], a1 = (g + 8, 2t) =
// x[4kk + 2], a2 = (g, 2t + 1) = x[4kk + 1], a3 = x[4kk + 3].
template <int NV, int BT>
__device__ __forceinline__ void gemm_tr(float (&c)[NV / 2],
                                        const float (&xh)[BT / 2],
                                        const uint32_t (&xl)[BT / 2],
                                        const uint8_t* t, int t_lo) {
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk) {
    const uint32_t ah[4] = {u32(xh[4 * kk]), u32(xh[4 * kk + 2]),
                            u32(xh[4 * kk + 1]), u32(xh[4 * kk + 3])};
    const uint32_t al[4] = {xl[4 * kk], xl[4 * kk + 2], xl[4 * kk + 1],
                            xl[4 * kk + 3]};
    const int to = (kk / 2) * NV * 64 + (kk % 2) * 32;
    const uint64_t bh = sm90::desc_sw64(t + to, 16);
    const uint64_t bl = sm90::desc_sw64(t + t_lo + to, 16);
    sm90::WgmmaTF32RS<NV>::run(c, al, bh);
    sm90::WgmmaTF32RS<NV>::run(c, ah, bl);
    sm90::WgmmaTF32RS<NV>::run(c, ah, bh);
  }
}

// x (in place: hi's bits) and xl (lo) = the tf32 split of x.
template <int N>
__device__ __forceinline__ void split(float (&x)[N], uint32_t (&xl)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t hi = tf32_rna(x[i]);
    xl[i] = tf32_rna(x[i] - f32(hi));
    x[i] = f32(hi);
  }
}

// A (64 x NV) accumulator times `mul` into rows row, row + 8 of a (S, D)
// view (contiguous head dim, even strides); rows past S and columns past D
// dropped.
template <int NV>
__device__ __forceinline__ void store_rows(float* base, long long ss, int S,
                                           int D, int row, int qd,
                                           const float (&c)[NV / 2],
                                           float mul) {
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const int col = n * 8 + 2 * qd;  // D % 8 == 0: col + 1 < D too
    if (col < D) {
      if (row < S)
        *reinterpret_cast<float2*>(base + row * ss + col) =
            make_float2(c[4 * n] * mul, c[4 * n + 1] * mul);
      if (row + 8 < S)
        *reinterpret_cast<float2*>(base + (row + 8) * ss + col) =
            make_float2(c[4 * n + 2] * mul, c[4 * n + 3] * mul);
    }
  }
}

struct Out {  // a (B, H, S, D) fp32 view, contiguous head dim
  float* p;
  long long sb, sh, ss;
};

struct Params {
  Out o0, o1;  // dq; or dk, dv
  const float* lse2;   // (B, H, sq_pad) fp32, zero past Sq
  const float* delta;  // (B, H, sq_pad) fp32, zero past Sq
  int B, H, Sq, Sk, D, sq_pad;
  float mul;  // dq_mul
};

// Shared memory of a block, its barriers initialised by thread 0.
template <class L>
__device__ __forceinline__ uint8_t* setup(uint8_t* raw, uint64_t*& full_r,
                                          uint64_t*& full, uint64_t*& empty) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  full_r = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  full = full_r + 1;
  empty = full + L::NS;
  if (threadIdx.x == 0) {
    sm90::mbar_init(full_r, 1);
    for (int s = 0; s < L::NS; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4 * L::NWG);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return smem;
}

// The producer's one thread: the resident pair (rows r0.. of parts 0-3 of
// the natural map tres: hi and lo of two operands) on full_r, then per step
// j the OPS streamed operands into the ring, one a slot: two natural ones
// (parts 2 o, 2 o + 1 of tnat, rows j BT..), then the transposed ones
// (parts 2 o', 2 o' + 1 of ttr, positions j BT..).
template <class L>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* full_r,
                                        uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* tres,
                                        const CUtensorMap* tnat,
                                        const CUtensorMap* ttr, int r0,
                                        int steps, int h, int b, int B) {
  constexpr int NB = L::DP / CB;
  constexpr int NNAT = 2;  // natural operands a step; the rest transposed
  sm90::mbar_expect_tx(full_r, 4 * L::RES_PART);
  for (int part = 0; part < 4; ++part)
    for (int c = 0; c < NB; ++c)
      sm90::tma_load_4d(smem + part * L::RES_PART + c * L::BR * 64, tres,
                        full_r, c * CB, r0, h, part * B + b);
  for (int i = 0; i < steps * L::OPS; ++i) {
    const int s = i % L::NS, j = i / L::OPS, o = i % L::OPS;
    uint8_t* sl = smem + L::SLOT_OFF + s * L::SLOT;
    sm90::mbar_wait(empty + s, ((i / L::NS) & 1) ^ 1);
    if (o < NNAT) {
      sm90::mbar_expect_tx(full + s, 2 * L::NAT_PART);
      for (int part = 0; part < 2; ++part)
        for (int c = 0; c < NB; ++c)
          sm90::tma_load_4d(sl + part * L::SLOT_PART + c * L::BT * 64, tnat,
                            full + s, c * CB, j * L::BT, h,
                            (2 * o + part) * B + b);
    } else {
      sm90::mbar_expect_tx(full + s, 2 * L::TR_PART);
      for (int part = 0; part < 2; ++part)
        for (int c = 0; c < L::BT / CB; ++c)
          sm90::tma_load_4d(sl + part * L::SLOT_PART + c * L::NVC * 64,
                            ttr, full + s, j * L::BT + c * CB, 0, h,
                            (2 * (o - NNAT) + part) * B + b);
    }
  }
}


// ---------------------------------------------------------------------------
// K6a' (3xTF32): dq for BR q rows, streaming kl, V and kl^T tiles of BT keys

template <int NV>
__global__ void __launch_bounds__(Cfg<NV, false>::NTHREADS, 1)
flash_bwd_dq_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tqn,
                              const __grid_constant__ CUtensorMap tkn,
                              const __grid_constant__ CUtensorMap tkt,
                              Params prm) {
  using L = Cfg<NV, false>;
  constexpr int BT = L::BT, BR = L::BR, NWG = L::NWG, NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full_r, *full, *empty;
  uint8_t* smem = setup<L>(smem_raw, full_r, full, empty);

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int nk = (prm.Sk + BT - 1) / BT;
  const int wg = threadIdx.x / 128;  // < NWG: consumers; NWG: producer

  if (wg == NWG) {
    if constexpr (NWG > 1) sm90::reg_dealloc<24>();
    if (threadIdx.x == NWG * 128)
      produce<L>(smem, full_r, full, empty, &tqn, &tkn, &tkt, q0, nk, h, b,
                 prm.B);
    return;
  }
  if constexpr (NWG > 1) sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int my_turn = 1 + NWG + wg, next_turn = 1 + NWG + (wg + 1) % NWG;
  const uint8_t* qa = smem + wg * 64 * 64;                 // qs hi; lo next
  const uint8_t* da = smem + 2 * L::RES_PART + wg * 64 * 64;  // dO hi
  const int row = q0 + wg * 64 + warp * 16 + g;
  const long long vrow = ((long long)b * prm.H + h) * prm.sq_pad + row;
  const float lse0 = prm.lse2[vrow], lse1 = prm.lse2[vrow + 8];
  const float dl0 = prm.delta[vrow], dl1 = prm.delta[vrow + 8];
  const bool ragged = prm.Sk % BT != 0;
  auto slot = [&](int i) {
    return smem + L::SLOT_OFF + (i % NS) * L::SLOT;
  };
  auto release = [&](int i) {
    if (lane == 0) sm90::mbar_arrive(empty + i % NS);
  };

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  float s[BT / 2], dp[BT / 2];  // S, then p; dP, then ds0's hi part
  uint32_t dl[BT / 2];          // ds0's lo part

  if (NWG > 1 && wg == NWG - 1) sm90::bar_arrive(1 + NWG, 256);  // 0 first
  sm90::mbar_wait(full_r, 0);
  for (int j = 0; j < nk; ++j) {
    const int ik = 3 * j, iv = ik + 1, it = ik + 2;
    sm90::mbar_wait(full + ik % NS, (ik / NS) & 1);
    sm90::mbar_wait(full + iv % NS, (iv / NS) & 1);
    if (NWG > 1) sm90::bar_sync(my_turn, 256);
    sm90::wgmma_fence();
    gemm_nat<L::KS, BR, BT>(s, qa, L::RES_PART, slot(ik), L::SLOT_PART);
    sm90::wgmma_commit();
    gemm_nat<L::KS, BR, BT>(dp, da, L::RES_PART, slot(iv), L::SLOT_PART);
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
    release(ik);
    release(iv);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      dp[4 * n] = s[4 * n] * (dp[4 * n] - dl0);
      dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - dl0);
      dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - dl1);
      dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - dl1);
    }
    split(dp, dl);
    sm90::mbar_wait(full + it % NS, (it / NS) & 1);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    gemm_tr<NV, BT>(acc, dp, dl, slot(it), L::SLOT_PART);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(dp);
    sm90::fence_regs(dl);
    release(it);
  }
  if (NWG > 1 && wg == 0) sm90::bar_sync(my_turn, 256);  // the last turn

  const Out& o = prm.o0;
  store_rows<NV>(o.p + b * o.sb + h * o.sh, o.ss, prm.Sq, prm.D, row, qd, acc,
                 prm.mul);
}

// ---------------------------------------------------------------------------
// K6b' (3xTF32): dk, dv for BR key rows, streaming qs, dO, qs^T and dO^T
// tiles of BT q rows.  Each consumer computes the transposed products
// S^T = kl.qs^T and dP^T = V.dO^T for its 64 key rows, so p^T and ds0^T
// land in A-fragment layout directly.

template <int NV>
__global__ void __launch_bounds__(Cfg<NV, true>::NTHREADS, 1)
flash_bwd_dkv_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tkn,
                               const __grid_constant__ CUtensorMap tqn,
                               const __grid_constant__ CUtensorMap tqt,
                               Params prm) {
  using L = Cfg<NV, true>;
  constexpr int BT = L::BT, BR = L::BR, NWG = L::NWG, NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full_r, *full, *empty;
  uint8_t* smem = setup<L>(smem_raw, full_r, full, empty);

  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int nq = (prm.Sq + BT - 1) / BT;
  const int wg = threadIdx.x / 128;

  if (wg == NWG) {
    if constexpr (NWG > 1) sm90::reg_dealloc<24>();
    if (threadIdx.x == NWG * 128)
      produce<L>(smem, full_r, full, empty, &tkn, &tqn, &tqt, k0, nq, h, b,
                 prm.B);
    return;
  }
  if constexpr (NWG > 1) sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int my_turn = 1 + NWG + wg, next_turn = 1 + NWG + (wg + 1) % NWG;
  const uint8_t* ka = smem + wg * 64 * 64;                    // kl hi
  const uint8_t* va = smem + 2 * L::RES_PART + wg * 64 * 64;  // V hi
  const long long vbase = ((long long)b * prm.H + h) * prm.sq_pad;
  const float* lse2 = prm.lse2 + vbase;
  const float* delta = prm.delta + vbase;
  auto slot = [&](int i) {
    return smem + L::SLOT_OFF + (i % NS) * L::SLOT;
  };
  auto release = [&](int i) {
    if (lane == 0) sm90::mbar_arrive(empty + i % NS);
  };

  float dk[NV / 2], dv[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[BT / 2], dp[BT / 2];  // S^T, then p^T's hi; dP^T, then ds0^T's
  uint32_t pl[BT / 2], dl[BT / 2];  // their lo parts

  if (NWG > 1 && wg == NWG - 1) sm90::bar_arrive(1 + NWG, 256);
  sm90::mbar_wait(full_r, 0);
  for (int i = 0; i < nq; ++i) {
    const int iq = 4 * i, id = iq + 1, iqt = iq + 2, idt = iq + 3;
    sm90::mbar_wait(full + iq % NS, (iq / NS) & 1);
    sm90::mbar_wait(full + id % NS, (id / NS) & 1);
    if (NWG > 1) sm90::bar_sync(my_turn, 256);
    sm90::wgmma_fence();
    gemm_nat<L::KS, BR, BT>(s, ka, L::RES_PART, slot(iq), L::SLOT_PART);
    sm90::wgmma_commit();
    gemm_nat<L::KS, BR, BT>(dp, va, L::RES_PART, slot(id), L::SLOT_PART);
    sm90::wgmma_commit();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (NWG > 1) sm90::bar_arrive(next_turn, 256);
    // p^T: column c of S^T is q row i BT + c (lse2, delta zero past Sq)
    float2 lv[BT / 8];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
      lv[n] = __ldg(reinterpret_cast<const float2*>(lse2 + i * BT + n * 8
                                                    + 2 * qd));
    sm90::wgmma_wait<1>();  // S^T done, dP^T may still run
    sm90::fence_regs(s);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      s[4 * n] = ex2(s[4 * n] - lv[n].x);
      s[4 * n + 1] = ex2(s[4 * n + 1] - lv[n].y);
      s[4 * n + 2] = ex2(s[4 * n + 2] - lv[n].x);
      s[4 * n + 3] = ex2(s[4 * n + 3] - lv[n].y);
    }
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
      lv[n] = __ldg(reinterpret_cast<const float2*>(delta + i * BT + n * 8
                                                    + 2 * qd));
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    release(iq);
    release(id);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      dp[4 * n] = s[4 * n] * (dp[4 * n] - lv[n].x);
      dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - lv[n].y);
      dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - lv[n].x);
      dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - lv[n].y);
    }
    split(s, pl);
    split(dp, dl);
    sm90::mbar_wait(full + iqt % NS, (iqt / NS) & 1);
    sm90::mbar_wait(full + idt % NS, (idt / NS) & 1);
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::wgmma_fence();
    gemm_tr<NV, BT>(dv, s, pl, slot(idt), L::SLOT_PART);
    gemm_tr<NV, BT>(dk, dp, dl, slot(iqt), L::SLOT_PART);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::fence_regs(s);
    sm90::fence_regs(pl);
    sm90::fence_regs(dp);
    sm90::fence_regs(dl);
    release(iqt);
    release(idt);
  }
  if (NWG > 1 && wg == 0) sm90::bar_sync(my_turn, 256);

  const int row = k0 + wg * 64 + warp * 16 + g;
  store_rows<NV>(prm.o0.p + b * prm.o0.sb + h * prm.o0.sh, prm.o0.ss,
                 prm.Sk, prm.D, row, qd, dk, 1.f);
  store_rows<NV>(prm.o1.p + b * prm.o1.sb + h * prm.o1.sh, prm.o1.ss,
                 prm.Sk, prm.D, row, qd, dv, 1.f);
}

// ---------------------------------------------------------------------------
// the split pre-pass

// A (B, H, S, D) fp32 view: element (b, h, s, d) at p + b sb + h sh + s ss
// + d sd.
struct View4 {
  const float* p;
  long long sb, sh, ss, sd;
};

// The scratch of one call, in floats: the natural operands as contiguous
// (part, B, H, S, D) stacks (parts qs_hi, qs_lo, dO_hi, dO_lo of the q
// side; kl_hi, kl_lo, V_hi, V_lo of the key side), the transposed ones as
// (part, B, H, D, Sp) stacks (qs^T_hi, qs^T_lo, dO^T_hi, dO^T_lo; kl^T_hi,
// kl^T_lo).
struct Scratch {
  float *qn, *kn, *qt, *kt;
};

inline Scratch scratch_of(float* p, int B, int H, int Sq, int Sk, int D) {
  const long long bh = (long long)B * H;
  const long long sqp = (Sq + 7) / 8 * 8, skp = (Sk + 7) / 8 * 8;
  Scratch s;
  s.qn = p;
  s.kn = s.qn + 4 * bh * Sq * D;
  s.qt = s.kn + 4 * bh * Sk * D;
  s.kt = s.qt + 4 * bh * D * sqp;
  return s;
}

// One block a 32-row tile of (b, h): tiles [0, ceil(Sq / 32)) of the q
// side (qs = qmul*q and dO: natural and transposed), then those of the key
// side (kl = kmul*k: natural and transposed; V natural).  Position c of
// each group of 8 of a transposed row holds row pi(c) = (c % 4) * 2 + c / 4
// of the group, zero at rows past S.
__global__ void __launch_bounds__(256)
split_bwd_kernel(View4 q, View4 dout, View4 k, View4 v, int B, int H,
                 int Sq, int Sk, int D, float qmul, float kmul, Scratch sc) {
  __shared__ float xs[2][32][MAX_D + 1];
  const int nqt = (Sq + 31) / 32;
  const bool qside = (int)blockIdx.x < nqt;
  const int r0 = (qside ? blockIdx.x : blockIdx.x - nqt) * 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = qside ? Sq : Sk, Sp = (S + 7) / 8 * 8;
  const View4 x0 = qside ? q : k, x1 = qside ? dout : v;
  const float mul = qside ? qmul : kmul;
  float* nat = qside ? sc.qn : sc.kn;
  float* tr = qside ? sc.qt : sc.kt;
  const long long bh = (long long)b * H + h;
  const long long part_n = (long long)B * H * S * D;
  const long long part_t = (long long)B * H * D * Sp;
  const float* X0 = x0.p + b * x0.sb + h * x0.sh;
  const float* X1 = x1.p + b * x1.sb + h * x1.sh;
  for (int i = threadIdx.x; i < 32 * D; i += 256) {
    const int r = i / D, d = i % D, row = r0 + r;
    float a = 0.f, c = 0.f;
    if (row < S) {
      // the fold: one fp32 multiply (no contraction into the split)
      a = __fmul_rn(__ldg(X0 + row * x0.ss + d * x0.sd), mul);
      c = __ldg(X1 + row * x1.ss + d * x1.sd);
      const long long at = (bh * S + row) * D + d;
      uint32_t hi = tf32_rna(a);
      nat[at] = f32(hi);
      nat[part_n + at] = f32(tf32_rna(a - f32(hi)));
      hi = tf32_rna(c);
      nat[2 * part_n + at] = f32(hi);
      nat[3 * part_n + at] = f32(tf32_rna(c - f32(hi)));
    }
    xs[0][r][d] = a;
    xs[1][r][d] = c;
  }
  __syncthreads();
  const int nop = qside ? 2 : 1;  // qs^T and dO^T; kl^T
  for (int i = threadIdx.x; i < nop * 32 * D; i += 256) {
    const int op = i / (32 * D), j = i % (32 * D), d = j / 32, c = j % 32;
    if (r0 + c >= Sp) continue;
    const float x = xs[op][(c & ~7) | ((c & 3) * 2 + ((c >> 2) & 1))][d];
    const uint32_t hi = tf32_rna(x);
    const long long at = (bh * D + d) * Sp + r0 + c;
    tr[2 * op * part_t + at] = f32(hi);
    tr[(2 * op + 1) * part_t + at] = f32(tf32_rna(x - f32(hi)));
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

// A 4-D map of a stack of `parts` contiguous (B, H, rows_dim, cols_dim)
// fp32 arrays, the parts folded into the batch dim (part p of batch b at
// p B + b): boxes of 16 columns by `rows`, 64-byte swizzle.
bool make_map_stack(CUtensorMap* map, const float* p, int cols, int rows_dim,
                    int H, int B, int parts, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows_dim,
                              (cuuint64_t)H, (cuuint64_t)B * parts};
  const cuuint64_t strides[3] = {
      (cuuint64_t)cols * 4, (cuuint64_t)rows_dim * cols * 4,
      (cuuint64_t)H * rows_dim * cols * 4};
  const cuuint32_t box[4] = {(cuuint32_t)CB, (cuuint32_t)rows, 1, 1};
  return sm90::make_map_nd(map, p, 4, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_64B,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

struct Call {
  View4 q, k, v, dout;
  Out o0, o1;
  const float *lse2, *delta;
  float* scratch;
  int B, H, Sq, Sk, D, sq_pad;
  float scale, mul;
};

inline Params params(const Call& a) {
  return Params{a.o0, a.o1, a.lse2, a.delta, a.B, a.H, a.Sq, a.Sk, a.D,
                a.sq_pad, a.mul};
}

template <int NV>
cudaError_t launch_dq(const Call& a, cudaStream_t stream) {
  using C = Cfg<NV, false>;
  const Scratch sc = scratch_of(a.scratch, a.B, a.H, a.Sq, a.Sk, a.D);
  const int skp = (a.Sk + 7) / 8 * 8;
  CUtensorMap tqn, tkn, tkt;
  if (!make_map_stack(&tqn, sc.qn, a.D, a.Sq, a.H, a.B, 4, C::BR)
      || !make_map_stack(&tkn, sc.kn, a.D, a.Sk, a.H, a.B, 4, C::BT)
      || !make_map_stack(&tkt, sc.kt, skp, a.D, a.H, a.B, 2, NV))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_bwd_dq_tf32_sm90_kernel<NV>,
                                     C::SMEM, raised);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Sq + 31) / 32 + (a.Sk + 31) / 32;
  split_bwd_kernel<<<dim3(tiles, a.H, a.B), 256, 0, stream>>>(
      a.q, a.dout, a.k, a.v, a.B, a.H, a.Sq, a.Sk, a.D, a.scale,
      1.4426950408889634f, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + C::BR - 1) / C::BR, a.H, a.B);
  flash_bwd_dq_tf32_sm90_kernel<NV><<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tqn, tkn, tkt, params(a));
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_dkv(const Call& a, cudaStream_t stream) {
  using C = Cfg<NV, true>;
  const Scratch sc = scratch_of(a.scratch, a.B, a.H, a.Sq, a.Sk, a.D);
  const int sqp = (a.Sq + 7) / 8 * 8;
  CUtensorMap tkn, tqn, tqt;
  if (!make_map_stack(&tkn, sc.kn, a.D, a.Sk, a.H, a.B, 4, C::BR)
      || !make_map_stack(&tqn, sc.qn, a.D, a.Sq, a.H, a.B, 4, C::BT)
      || !make_map_stack(&tqt, sc.qt, sqp, a.D, a.H, a.B, 4, NV))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_bwd_dkv_tf32_sm90_kernel<NV>,
                                     C::SMEM, raised);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + C::BR - 1) / C::BR, a.H, a.B);
  flash_bwd_dkv_tf32_sm90_kernel<NV><<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tkn, tqn, tqt, params(a));
  return cudaGetLastError();
}

bool bad_out(const Out& o) {
  return (o.sb | o.sh | o.ss) % 2 || reinterpret_cast<uintptr_t>(o.p) % 8;
}

bool bad_call(const Call& a) {
  return a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.D <= 0
         || a.D > MAX_D || a.D % 8 || a.B > 65535 || a.H > 65535
         || a.sq_pad % 128 || a.sq_pad < a.Sq || a.scratch == nullptr
         || reinterpret_cast<uintptr_t>(a.scratch) % 16
         || a.lse2 == nullptr || a.delta == nullptr;
}

Out out_view(void* p, const long long* st) {
  return Out{static_cast<float*>(p), st[0], st[1], st[2]};
}

}  // namespace

// K6a' and K6b' in fp32 for D a multiple of 8 up to 160.  q, k, v, dout:
// (B, H, S, D) fp32 views of any strides (`st`: each one's (batch, head,
// seq, dim) strides in elements, in that order); lse2 and delta contiguous
// (B, H, sq_pad) fp32, zero past Sq, sq_pad a multiple of 128; `scratch` a
// 16-byte aligned fp32 buffer of 4 B H (Sq + Sk) D + B H D (4 Sqp + 2 Skp)
// floats (Sqp, Skp: Sq, Sk rounded up to 8).  The dq entry launches the
// split pre-pass, which fills the scratch from q, k, v and dout (folding
// qs = scale q and kl = log2e k), then the dq kernel into dq (a contiguous
// head dim, its (batch, head, seq) strides in `ost`, even, 8-byte
// aligned); the dk/dv entry reads the scratch the dq entry filled.  Each
// returns cudaGetLastError() after its launches.
extern "C" int sdbc_flash_bwd_dq_tf32_sm90(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse2,
                                           const void* delta, void* dq,
                                           void* scratch, int B, int H,
                                           int Sq, int Sk, int D, int sq_pad,
                                           const long long* st,
                                           const long long* ost, float scale,
                                           float dq_mul, void* stream) {
  auto view = [&](const void* p, int i) {
    return View4{static_cast<const float*>(p), st[4 * i], st[4 * i + 1],
                 st[4 * i + 2], st[4 * i + 3]};
  };
  Call a{};
  a.q = view(q, 0), a.k = view(k, 1), a.v = view(v, 2), a.dout = view(dout, 3);
  a.o0 = out_view(dq, ost);
  a.lse2 = static_cast<const float*>(lse2);
  a.delta = static_cast<const float*>(delta);
  a.scratch = static_cast<float*>(scratch);
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D, a.sq_pad = sq_pad;
  a.scale = scale, a.mul = dq_mul;
  if (bad_call(a) || bad_out(a.o0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 40) return (int)launch_dq<40>(a, s);
  if (D <= 80) return (int)launch_dq<80>(a, s);
  return (int)launch_dq<160>(a, s);
}

extern "C" int sdbc_flash_bwd_dkv_tf32_sm90(const void* lse2,
                                            const void* delta, void* dk,
                                            void* dv, void* scratch, int B,
                                            int H, int Sq, int Sk, int D,
                                            int sq_pad, const long long* ost,
                                            void* stream) {
  Call a{};
  a.o0 = out_view(dk, ost);
  a.o1 = out_view(dv, ost + 3);
  a.lse2 = static_cast<const float*>(lse2);
  a.delta = static_cast<const float*>(delta);
  a.scratch = static_cast<float*>(scratch);
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D, a.sq_pad = sq_pad;
  if (bad_call(a) || bad_out(a.o0) || bad_out(a.o1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 40) return (int)launch_dkv<40>(a, s);
  if (D <= 80) return (int)launch_dkv<80>(a, s);
  return (int)launch_dkv<160>(a, s);
}
