// Fixed-cap attention with an int8 Q.K^T for Hopper (sm_90a), on TMA-fed
// wgmma: the fixed-cap variant of flash_fwd_sm90.cu with the score product
// in s8 x s8 -> s32 and the quantization of q and k inside the call.
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/ops/flash_attention.py
// _int8_kernel (via _flash_fixed_fwd_int8), which nothing dispatches: the
// SageAttention split, int8 scores and a bf16 P.V.  q and k are quantized
// per row as the JAX wrapper does outside its kernel: absmax over the head
// dim in fp32, s = max(absmax, 1e-8) / 127, round(x / s) half to even
// (IEEE division, cvt.rni), int8; scale*log2e is folded into q's row scale.
//   s_ij = (float(qi_i . ki_j) * qs_i) * ks_j   (s32 product, log2 units)
//   p_ij = exp2(min(s_ij, 60))                   (no running max: the cap)
//   l_i  = sum_j p_ij in fp32
//   o_i  = sum_j bf16(p_ij) v_j / max(l_i, 1e-37)
// Keys past Sk get p = 0 and rows past Sq are not written (the JAX wrapper
// instead drops a ragged KV tail).
//
// What bounds it on the H100: per score 2*D int8 operations (1979 TOP/s),
// 2*D bf16 FLOPs (989 TFLOP/s) and one exp2 (~3.9 T/s on the special-
// function units): at the sampling head dims 40 and 80 the exponentials.
// A score also costs about four issue slots more than in the bf16 kernel:
// the s32 -> fp32 conversion is an integer add and an FADD (the magic
// number 1.5 * 2^23: |s32| <= D * 127^2 < 2^22, so exact, and no I2F,
// which runs at the special-function rate), then the two row-scale FMULs.
//
// Design (flash_fwd_sm90.cu's fixed-cap kernel; sm90.cuh):
// - A block owns a 128-row q tile of one (batch, head): one producer
//   warpgroup and two consumer warpgroups of 64 rows each.  q, k, v and o
//   are read and written through 4-D (D, S, H, B) tensor maps built from the
//   caller's strides: no copy of any of them.
// - The consumers quantize their rows of the bf16 Q tile (TMA-loaded as in
//   flash_fwd_sm90.cu) into an int8 tile of 128-byte column blocks in the
//   128-byte swizzle, two threads a row, and keep the row scales (times
//   scale*log2e) in shared memory; a proxy fence orders the stores before
//   the first wgmma.
// - A pre-pass launch (quantize_k_kernel, one thread a key row) quantizes
//   K once into an int8 (B, H, Sk, D8) buffer and fp32 row scales; the
//   producer TMA-loads the int8 tiles (a uint8 tensor map) into a 2-stage
//   ring and bulk-copies their scales.  Two launches a call: quantizing
//   each K tile in the attention kernel instead re-quantizes every key once
//   per 128-row q tile, and was 2.4-4.2x slower at the 32^2 and 64^2
//   sampling shapes on an H100.
// - S = Q8.K8^T on wgmma m64nBKk32 s32.s8.s8, both operands K-major; the
//   k32 steps past D are skipped (2, 3 and 5 at D = 40, 80 and 160).  The
//   s32 accumulator has the f32 fragment layout, so the conversion, the
//   exponentials, the bf16 P repack and O += P.V (V read MN-major from its
//   row-major tile) are flash_fwd_sm90.cu's, as are the consumers' turns
//   and the TMA-store epilogue.

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::pack_bf16;
using sm90::quad_sum;
using sm90::swz;

typedef __nv_bfloat16 bf16;

constexpr int STAGES = 2;
constexpr int CB = 64;      // bf16 columns per swizzled column block
constexpr int NWG = 2;      // consumer warpgroups
constexpr int BQ = 64 * NWG;
constexpr int NTHREADS = 128 * (NWG + 1);
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100
constexpr float CAP = 60.f;
constexpr float NEG_INF = -1e30f;

// The block's shape for padded head dim DP and KS8 k32 steps of Q.K^T.
template <int DP, int KS8>
struct Cfg {
  static_assert(DP % CB == 0 && KS8 * 32 <= DP, "bad head-dim padding");
  // KV rows per tile (as flash_fwd_sm90.cu): 128 at DP = 64, 64 above
  static constexpr int BK = DP == 64 ? 128 : 64;
  static constexpr int NB8 = (KS8 * 32 + 127) / 128;  // int8 column blocks
  static constexpr int Q_BYTES = BQ * DP * 2;    // the bf16 Q tile, then O
  static constexpr int Q8_BYTES = BQ * NB8 * 128;
  static constexpr int K8_BYTES = BK * NB8 * 128;  // one int8 K tile
  static constexpr int KV_BYTES = BK * DP * 2;     // one bf16 K or V tile
  static constexpr int KS_BYTES = BK * 4;          // one tile's K scales
  static constexpr int Q8_OFF = Q_BYTES;
  static constexpr int K8_OFF = Q8_OFF + Q8_BYTES;
  static constexpr int V_OFF = K8_OFF + STAGES * K8_BYTES;
  static constexpr int KSC_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int QSC_OFF = KSC_OFF + STAGES * KS_BYTES;
  static constexpr int BAR_OFF = QSC_OFF + BQ * 4;
  // full_q, full_k8[S], full_v[S], empty_k8[S], empty_v[S]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES)
                              + 1024;  // room to align the base
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

// The exact float of an s32 score (|v| < 2^22): integer add into the
// mantissa of 1.5 * 2^23, then one FADD.
__device__ __forceinline__ float s32_to_f32(uint32_t v) {
  return __int_as_float(static_cast<int>(v) + 0x4B400000) - 12582912.f;
}

__device__ __forceinline__ float absmax8(const uint4& u, float m) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(__bfloat162float(e[k])));
  return m;
}

// round(x / s) half to even of 8 bf16 values, as 8 int8 bytes
__device__ __forceinline__ uint2 quant8(const uint4& u, float s) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = __float2int_rn(__bfloat162float(e[k]) / s);
    w[k / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (k % 4));
  }
  return make_uint2(w[0], w[1]);
}

// Quantizes row r of the bf16 Q tile in shared memory (64-column blocks of
// BQ rows, 128-byte swizzle) into row r of the int8 Q tile (128-byte column
// blocks of BQ rows, the same swizzle): NCH 8-element chunks, two adjacent
// threads a row, this one taking chunks part, part + 2, ...  Returns the
// row's scale max(absmax, 1e-8) / 127.
template <int NCH>
__device__ __forceinline__ float quantize_row(const uint8_t* src,
                                              uint8_t* dst, int r, int part) {
  auto chunk = [&](int c) {
    return *reinterpret_cast<const uint4*>(
        src + (c / 8) * BQ * 128 + r * 128 + (((c % 8) ^ r) & 7) * 16);
  };
  float m = 0.f;
  for (int c = part; c < NCH; c += 2) m = absmax8(chunk(c), m);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  const float s = fmaxf(m, 1e-8f) / 127.f;
  for (int c = part; c < NCH; c += 2)
    *reinterpret_cast<uint2*>(dst + (c / 16) * BQ * 128 + r * 128
                              + ((((c % 16) / 2) ^ r) & 7) * 16
                              + (c % 2) * 8) = quant8(chunk(c), s);
  return s;
}

// S (64 x BK, s32) = Q8_w (64 x 32 KS8) . K8^T: KS8 k32 steps, both K-major.
template <int KS8, int BK>
__device__ __forceinline__ void gemm_qk8(uint32_t (&s)[BK / 2],
                                         const uint8_t* qw,
                                         const uint8_t* kt) {
#pragma unroll
  for (int ks = 0; ks < KS8; ++ks) {
    const int off = (ks % 4) * 32;  // k32 step inside a column block
    const uint64_t a = sm90::desc_sw128(qw + (ks / 4) * BQ * 128 + off, 16);
    const uint64_t b = sm90::desc_sw128(kt + (ks / 4) * BK * 128 + off, 16);
    sm90::WgmmaS8<BK>::run(s, a, b, ks > 0);
  }
}

// O (64 x NV) += P (64 x BK, registers) . V (BK x DP, row-major tile read
// MN-major): BK/16 k16 steps of 16 V rows (2048 bytes) each.
template <int NV, int BK>
__device__ __forceinline__ void gemm_pv(float (&o)[NV / 2],
                                        const uint32_t (&p)[BK / 16][4],
                                        const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::WgmmaRS<NV>::run(o, p[kk], sm90::desc_sw128(vt + kk * 16 * 128,
                                                      BK * 128));
}

struct Params {
  int H, Sq, Sk;
  float qscale;    // scale * log2e
  const float* ks; // the pre-pass's (B, H, Skp) fp32 K row scales
  int Skp;         // Sk rounded up to 128
};

template <int DP, int KS8, int NV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_int8_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const __grid_constant__ CUtensorMap tk8, Params prm) {
  using L = Cfg<DP, KS8>;
  constexpr int BK = L::BK, NCB = DP / CB, NB8 = L::NB8;
  constexpr int NCH = KS8 * 4;  // 8-element chunks quantized a row (>= D)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;  // the bf16 Q tile, then this block's O
  uint8_t* q8 = smem + L::Q8_OFF;
  float* ksc = reinterpret_cast<float*>(smem + L::KSC_OFF);
  float* qsc = reinterpret_cast<float*>(smem + L::QSC_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;  // the int8 K tile and its scales
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (prm.Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;  // < NWG: consumers; NWG: producer
  auto k8_tile = [&](int j) {
    return smem + L::K8_OFF + (j % STAGES) * L::K8_BYTES;
  };
  auto v_tile = [&](int j) {
    return smem + L::V_OFF + (j % STAGES) * L::KV_BYTES;
  };

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
    // ---- producer: one thread issues every copy
    sm90::reg_dealloc<40>();
    if (threadIdx.x == NWG * 128) {
      sm90::mbar_expect_tx(full_q, L::Q_BYTES);
      for (int c = 0; c < NCB; ++c)
        sm90::tma_load_4d(sq + c * BQ * 128, &tq, full_q, c * CB, q0, h, b);
      const float* ks = prm.ks + ((long long)b * prm.H + h) * prm.Skp;
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = ((j / STAGES) & 1) ^ 1;
        sm90::mbar_wait(empty_k + s, ph);
        sm90::mbar_expect_tx(full_k + s, L::K8_BYTES + L::KS_BYTES);
        for (int c = 0; c < NB8; ++c)
          sm90::tma_load_4d(k8_tile(j) + c * BK * 128, &tk8, full_k + s,
                            c * 128, j * BK, h, b);
        sm90::bulk_load(ksc + s * BK, ks + j * BK, L::KS_BYTES, full_k + s);
        sm90::mbar_wait(empty_v + s, ph);
        sm90::mbar_expect_tx(full_v + s, L::KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          sm90::tma_load_4d(v_tile(j) + c * BK * 128, &tv, full_v + s,
                            c * CB, j * BK, h, b);
      }
    }
  } else {
    // ---- consumers
    sm90::reg_alloc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const int wbar = 1 + wg;  // this consumer's own named barrier
    // turns to issue products, round robin over the consumers
    const int my_turn = 1 + NWG + wg, next_turn = 1 + NWG + (wg + 1) % NWG;
    uint8_t* qw = sq + wg * 64 * 128;   // this consumer's rows, bf16 (then O)
    uint8_t* qw8 = q8 + wg * 64 * 128;  // and int8

    // Q: quantize this consumer's 64 rows, two threads a row
    sm90::mbar_wait(full_q, 0);
    {
      const int r = wg * 64 + t / 2;
      const float sc = quantize_row<NCH>(sq, q8, r, t % 2);
      if (t % 2 == 0) qsc[r] = sc * prm.qscale;
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(wbar, 128);
    const float qs0 = qsc[wg * 64 + warp * 16 + g];  // rows g and g + 8
    const float qs1 = qsc[wg * 64 + warp * 16 + g + 8];

    float o[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
    uint32_t si[BK / 2];
    float s[BK / 2];
    uint32_t p[BK / 16][4];
    float l0 = 0.f, l1 = 0.f;  // this thread's partial row sums
    const bool ragged = prm.Sk % BK != 0;

    // S_j to log2-unit floats: (s32 * qs_i) * ks_j; keys past Sk masked
    auto scores = [&](int j) {
      const float* kst = ksc + (j % STAGES) * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 kk = *reinterpret_cast<const float2*>(kst + n * 8
                                                            + 2 * qd);
        s[4 * n] = s32_to_f32(si[4 * n]) * qs0 * kk.x;
        s[4 * n + 1] = s32_to_f32(si[4 * n + 1]) * qs0 * kk.y;
        s[4 * n + 2] = s32_to_f32(si[4 * n + 2]) * qs1 * kk.x;
        s[4 * n + 3] = s32_to_f32(si[4 * n + 3]) * qs1 * kk.y;
      }
      if (ragged && j == nk - 1) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int col = j * BK + n * 8 + 2 * qd;
          if (col >= prm.Sk) s[4 * n] = s[4 * n + 2] = NEG_INF;
          if (col + 1 >= prm.Sk) s[4 * n + 1] = s[4 * n + 3] = NEG_INF;
        }
      }
    };
    // p = exp2(min(s, 60)) in place, and the row sums (masked: p = 0)
    auto softmax = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = ex2(fminf(s[i], CAP));
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        l0 += s[4 * n] + s[4 * n + 1];
        l1 += s[4 * n + 2] + s[4 * n + 3];
      }
    };
    // P_j as bf16 A fragments (flash_fwd_sm90.cu's repack)
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    if (wg == NWG - 1) sm90::bar_arrive(1 + NWG, 256);  // consumer 0 first

    // KV tile 0: S_0 alone
    sm90::mbar_wait(full_k, 0);
    sm90::bar_sync(my_turn, 256);
    sm90::wgmma_fence();
    gemm_qk8<KS8, BK>(si, qw8, k8_tile(0));
    sm90::wgmma_commit();
    sm90::fence_regs(si);
    sm90::bar_arrive(next_turn, 256);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(si);
    scores(0);
    release(empty_k);  // the K tile and its scales are read
    softmax();
    pack();

    for (int j = 1; j < nk; ++j) {
      const uint32_t ph = (j / STAGES) & 1, pph = ((j - 1) / STAGES) & 1;
      sm90::mbar_wait(full_k + j % STAGES, ph);
      sm90::bar_sync(my_turn, 256);
      sm90::wgmma_fence();
      gemm_qk8<KS8, BK>(si, qw8, k8_tile(j));
      sm90::wgmma_commit();
      sm90::fence_regs(si);
      sm90::mbar_wait(full_v + (j - 1) % STAGES, pph);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      gemm_pv<NV, BK>(o, p, v_tile(j - 1));
      sm90::wgmma_commit();
      sm90::fence_regs(o);
      sm90::bar_arrive(next_turn, 256);
      sm90::wgmma_wait<1>();  // S_j done, P_{j-1}.V_{j-1} may still run
      sm90::fence_regs(si);
      scores(j);
      release(empty_k + j % STAGES);
      softmax();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(empty_v + (j - 1) % STAGES);
      pack();
    }

    // the last P.V
    sm90::mbar_wait(full_v + (nk - 1) % STAGES, ((nk - 1) / STAGES) & 1);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    gemm_pv<NV, BK>(o, p, v_tile(nk - 1));
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
    const float i0 = 1.f / fmaxf(l0, 1e-37f);
    const float i1 = 1.f / fmaxf(l1, 1e-37f);
    const int r0 = warp * 16 + g;  // row within this consumer's 64
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) {
      const int col = n * 8 + 2 * qd;
      *reinterpret_cast<uint32_t*>(qw + swz(r0, col, BQ)) =
          pack_bf16(o[4 * n] * i0, o[4 * n + 1] * i0);
      *reinterpret_cast<uint32_t*>(qw + swz(r0 + 8, col, BQ)) =
          pack_bf16(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(wbar, 128);
    if (t == 0 && q0 + wg * 64 < prm.Sq) {
      for (int c = 0; c < NCB; ++c)
        sm90::tma_store_4d(&to, qw + c * BQ * 128, c * CB, q0 + wg * 64, h,
                           b);
      sm90::tma_store_commit_and_wait();
    }
  }
}

// The pre-pass: one thread a key row (b, h, row) of the bf16 view `k`
// (strides in elements): the row's int8 values into the contiguous
// (B, H, Sk, D8) buffer `k8` (D8 = D rounded up to 16, zeros past D) and its
// scale into the (B, H, Skp) buffer `ks` (zeros for rows Sk..Skp).
__global__ void __launch_bounds__(128)
quantize_k_kernel(const bf16* k, long long sb, long long ss, long long sh,
                  int H, int Sk, int D, int D8, int Skp, int8_t* k8,
                  float* ks) {
  const int row = blockIdx.x * 128 + threadIdx.x;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  if (row >= Skp) return;
  if (row >= Sk) {
    ks[bh * Skp + row] = 0.f;
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(
      k + blockIdx.z * sb + row * ss + blockIdx.y * sh);
  const int nch = D / 8;
  float m = 0.f;
  for (int c = 0; c < nch; ++c) m = absmax8(__ldg(src + c), m);
  const float s = fmaxf(m, 1e-8f) / 127.f;
  uint4* dst = reinterpret_cast<uint4*>(k8 + (bh * Sk + row) * D8);
  for (int c = 0; c < D8 / 16; ++c) {
    const uint2 lo = 2 * c < nch ? quant8(__ldg(src + 2 * c), s)
                                 : make_uint2(0u, 0u);
    const uint2 hi = 2 * c + 1 < nch ? quant8(__ldg(src + 2 * c + 1), s)
                                     : make_uint2(0u, 0u);
    dst[c] = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  ks[bh * Skp + row] = s;
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

using sm90::View;
using sm90::make_map;

// A 4-D (D8, Sk, H, B) uint8 map of the pre-pass's contiguous int8 buffer,
// boxes of 128 bytes by `rows` keys, 128-byte swizzle: bytes past D8 read as
// zeros.
bool make_map_k8(CUtensorMap* map, const void* k8, int B, int H, int Sk,
                 int D8, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D8, (cuuint64_t)Sk, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D8, (cuuint64_t)Sk * D8,
                                 (cuuint64_t)H * Sk * D8};
  const cuuint32_t box[4] = {128, (cuuint32_t)rows, 1, 1};
  return sm90::make_map_nd(map, k8, 4, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

template <int DP, int KS8, int NV>
cudaError_t launch(const View& q, const View& k, const View& v, const View& o,
                   int8_t* k8, float* ks, int B, int H, int Sq, int Sk, int D,
                   float qscale, cudaStream_t stream) {
  using C = Cfg<DP, KS8>;
  const int D8 = (D + 15) / 16 * 16, Skp = (Sk + 127) / 128 * 128;
  CUtensorMap tq, tv, to, tk8;
  if (!make_map(&tq, q, B, Sq, H, D, BQ)
      || !make_map(&tv, v, B, Sk, H, D, C::BK)
      || !make_map(&to, o, B, Sq, H, D, 64)
      || !make_map_k8(&tk8, k8, B, H, Sk, D8, C::BK))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_int8_sm90_kernel<DP, KS8, NV>,
                                     C::SMEM, raised);
  if (err != cudaSuccess) return err;
  quantize_k_kernel<<<dim3(Skp / 128, H, B), 128, 0, stream>>>(
      static_cast<const bf16*>(k.p), k.sb, k.ss, k.sh, H, Sk, D, D8, Skp, k8,
      ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Params prm{H, Sq, Sk, qscale, ks, Skp};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_int8_sm90_kernel<DP, KS8, NV>
      <<<grid, NTHREADS, C::SMEM, stream>>>(tq, tv, to, tk8, prm);
  return cudaGetLastError();
}

}  // namespace

// K10: q/k/v/o bf16 (B, H, S, D) views, `st` holding (batch, head, seq)
// strides in elements, three per tensor in argument order (multiples of 8,
// a contiguous head dim, 16-byte aligned), D <= 256 and a multiple of 8.
// `k8` is an int8 buffer of B*H*Sk*D8 bytes (D8 = D rounded up to 16) and
// `ks` an fp32 one of B*H*Skp floats (Skp = Sk rounded up to 128), both
// 16-byte aligned, which the pre-pass fills.  Two launches; returns
// cudaGetLastError() after them.
extern "C" int sdbc_flash_int8_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* k8,
                                    void* ks, int B, int H, int Sq, int Sk,
                                    int D, const long long* st, float qscale,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 || D % 8
      || B > 65535 || H > 65535 || k8 == nullptr || ks == nullptr)
    return (int)cudaErrorInvalidValue;
  auto view = [&](const void* p, int i) {
    return View{p, st[3 * i], st[3 * i + 2], st[3 * i + 1]};
  };
  const View vq = view(q, 0), vk = view(k, 1), vv = view(v, 2), vo = view(o, 3);
  int8_t* k8p = static_cast<int8_t*>(k8);
  float* ksp = static_cast<float*>(ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDBC_LAUNCH(DP, KS8, NV)                                         \
  (int)launch<DP, KS8, NV>(vq, vk, vv, vo, k8p, ksp, B, H, Sq, Sk, D,    \
                           qscale, s)
  // the main path's head dims (40, 80, 160) with their k32 steps and
  // output columns trimmed; the others take a whole padded block
  if (D <= 48) return SDBC_LAUNCH(64, 2, 48);
  if (D <= 64) return SDBC_LAUNCH(64, 2, 64);
  if (D <= 80) return SDBC_LAUNCH(128, 3, 80);
  if (D <= 128) return SDBC_LAUNCH(128, 4, 128);
  if (D <= 160) return SDBC_LAUNCH(192, 5, 160);
  if (D <= 192) return SDBC_LAUNCH(192, 6, 192);
  return SDBC_LAUNCH(256, 8, 256);
#undef SDBC_LAUNCH
}
