// Flash-attention forward in fp32 for Hopper (sm_90a) on TMA-fed tf32
// wgmma, each product split in three ("3xTF32"): one kernel template for
// the fixed-cap sampling attention and the training forward that emits the
// log-sum-exp, for fp32 q/k/v with a head dim that is a multiple of 8, up
// to 256 (the bf16 calls go to flash_fwd_sm90.cu).
//
// Replaces, for those calls, the JAX package's Pallas kernels (which take
// any dtype):
//   FIXED = true  <- sdbc_tpu/ops/flash_attention.py _fixed_kernel_bshd,
//                    _fixed_kernel_raw and _fixed_kernel
//   FIXED = false <- sdbc_tpu/ops/flash_attention.py _fwd_kernel
// and, for the same calls, the CUDA-core flash_simt_fwd_kernel of
// flash_simt.cu, which keeps the head dims that are not a multiple of 8 or
// lie above 256.
//
// Math: flash_simt.cu's fp32 forward with its rounding points.  q is
// prescaled by scale*log2e in fp32, s = q.k^T in log2 units; the fixed cap
// p = exp2(min(s, 60)), o = sum p.v / max(l, 1e-37); the training forward a
// running row max m, p = exp2(s - m), each tile rescaling l and o, and
// lse = m*ln2 + ln l; l summed from the fp32 p.  Each product a.b of fp32
// operands is a_hi.b_hi + a_hi.b_lo + a_lo.b_hi with x_hi = tf32(x),
// x_lo = tf32(x - x_hi) (cvt.rna), each term exact in fp32 and summed in
// the fp32 accumulator: a_lo.b_lo (~2^-22 of a.b) and the rounding of the
// lo parts (~2^-22) are lost, against fp32's own 2^-24.
//
// What bounds it on the H100: per score 3 x 4*D tensor FLOPs at 495 TFLOP/s
// (tf32) and one exp2 (~3.9 T/s on the special-function units): at D = 40
// the products, 3.7x the exponentials.  The FFMA kernel it replaces did
// 4*D FLOPs a score at 67 TFLOP/s, 2.5x this bound.
//
// Design (flash_fwd_sm90.cu's, on sm90.cuh's PTX):
// - tf32 products take both operands K-major, so P.V needs V with the keys
//   contiguous.  A pre-pass launch (split_kv_kernel, one block a 32-key
//   tile) writes K_hi and K_lo as contiguous (B, H, Sk, D) and V^T_hi and
//   V^T_lo as (B, H, D, Skp) fp32 scratch (Skp = Sk rounded up to 8, zero
//   past Sk), from k and v of any strides.  Within each group of 8 keys
//   V^T holds key pi(c) = (c % 4) * 2 + c / 4 at position c: the S
//   accumulator holds keys 2t and 2t + 1 of each 8 (t = lane % 4) where
//   the tf32 A fragment takes columns t and t + 4, so P goes from the S
//   registers to the A registers with no shuffle.
// - A block owns BQ = 64 NWG q rows of one (batch, head): a producer
//   warpgroup, one thread of which keeps the TMA loads in flight, and NWG
//   consumer warpgroups of 64 rows.  Q arrives once through a 4-D
//   (D, S, H, B) map of the caller's strides; the K tiles (hi and lo) and
//   the V^T tiles (hi and lo) go through one ring of NS slots in the order
//   K_0, V_0, K_1, V_1, ..., so later tiles land while earlier ones are
//   read.  Every tile is a stack of 32-column (128-byte) blocks in the
//   128-byte swizzle; rows past Sq, keys past Skp and columns past D arrive
//   as zeros.
// - The consumers prescale their Q rows and split them in shared memory
//   (Q_hi in place, Q_lo beside it).  Per key tile: S = Q.K^T, NV / 8 k8
//   steps of three wgmma m64nBKk8 from shared memory (lo.hi, hi.lo,
//   hi.hi); keys past Sk masked; the softmax in fp32 with ex2; P split into
//   hi and lo registers; O += P.V, BK / 8 k8 steps of three wgmma m64nNVk8
//   with P from registers.  With NWG = 2 one consumer's softmax overlaps
//   the other's products.
// - Epilogue: O / l stored from registers, 8 bytes a thread (rows past Sq
//   and columns past D dropped); the training forward writes the lse row.
// - Q hi and lo (2 BQ DP 4 bytes, DP = NV rounded up to 32) and the ring
//   share the 227 KB of shared memory; per instantiation (NV >= D, a
//   multiple of 8: the main path's 40, 80 and 160 exactly):
//     NV 40, 64: NWG 2, BK 64, 4 slots (192 KB)
//     NV 80:     NWG 2, BK 64, 2 slots (192 KB)
//     NV 128:    NWG 2, BK 32, 3 slots (224 KB)
//     NV 160:    NWG 1, BK 32, 3 slots (200 KB)
//     NV 192:    NWG 1, BK 32, 2 slots (192 KB)
//     NV 256:    NWG 1, BK 32, 1 slot  (192 KB: K and V^T in turn)

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::quad_max;
using sm90::quad_sum;
using sm90::tf32_rna;

constexpr int CB = 32;  // fp32 columns of a swizzled column block
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100
constexpr float CAP = 60.f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

// The block's shape for NV output columns (and NV / 8 k8 steps of Q.K^T).
template <int NV>
struct Cfg {
  static_assert(NV % 8 == 0 && NV <= 256, "bad head dim");
  static constexpr int DP = (NV + CB - 1) / CB * CB;
  static constexpr int KS = NV / 8;
  static constexpr int NWG = NV <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BK = NV <= 80 ? 64 : 32;  // keys a tile
  static constexpr int NS = NV <= 64    ? 4
                            : NV <= 80  ? 2
                            : NV <= 160 ? 3
                            : NV <= 192 ? 2
                                        : 1;  // ring slots
  static constexpr int BQ = 64 * NWG;
  static constexpr int NTHREADS = 128 * (NWG + 1);
  static constexpr int Q_BYTES = BQ * DP * 4;  // Q_hi; Q_lo follows
  static constexpr int K_BYTES = BK * DP * 4;  // K_hi; K_lo follows
  static constexpr int V_BYTES = NV * BK * 4;  // V^T_hi; V^T_lo follows
  static constexpr int SLOT = 2 * (K_BYTES > V_BYTES ? K_BYTES : V_BYTES);
  static constexpr int SLOT_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = SLOT_OFF + NS * SLOT;
  // full_q, full[NS], empty[NS]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS)
                              + 1024;  // room to align the base
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0
                    && V_BYTES % 1024 == 0,
                "tiles on 1024-byte boundaries");
};

__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t u32(float x) { return __float_as_uint(x); }

// S (64 x BK) = Q_w . K^T in three products a k8 step; qh/ql: the
// consumer's rows of the Q_hi / Q_lo tiles (BQ rows a column block),
// kh/kl: the K_hi / K_lo tiles (BK rows a column block).
template <int KS, int BQ, int BK>
__device__ __forceinline__ void gemm_qk(float (&s)[BK / 2], const uint8_t* qh,
                                        const uint8_t* ql, const uint8_t* kh,
                                        const uint8_t* kl) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int qo = (ks / 4) * BQ * 128 + (ks % 4) * 32;
    const int ko = (ks / 4) * BK * 128 + (ks % 4) * 32;
    const uint64_t ah = sm90::desc_sw128(qh + qo, 16);
    const uint64_t al = sm90::desc_sw128(ql + qo, 16);
    const uint64_t bh = sm90::desc_sw128(kh + ko, 16);
    const uint64_t bl = sm90::desc_sw128(kl + ko, 16);
    sm90::WgmmaTF32SS<BK>::run(s, al, bh, ks > 0);
    sm90::WgmmaTF32SS<BK>::run(s, ah, bl, 1);
    sm90::WgmmaTF32SS<BK>::run(s, ah, bh, 1);
  }
}

// O (64 x NV) += P (64 x BK: ph, the S registers holding P_hi's bits, and
// pl, P_lo) . V, read from the V^T_hi / V^T_lo tiles (vh, vl: NV rows a
// 32-key column block, keys permuted by pi within each 8).  k8 step kk
// takes S chunk kk: a0 = (g, key 2t) = s[4kk], a1 = (g + 8, key 2t) =
// s[4kk + 2], a2 = (g, key 2t + 1) = s[4kk + 1], a3 = s[4kk + 3].
template <int NV, int BK>
__device__ __forceinline__ void gemm_pv(float (&o)[NV / 2],
                                        const float (&ph)[BK / 2],
                                        const uint32_t (&pl)[BK / 2],
                                        const uint8_t* vh,
                                        const uint8_t* vl) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t ah[4] = {u32(ph[4 * kk]), u32(ph[4 * kk + 2]),
                            u32(ph[4 * kk + 1]), u32(ph[4 * kk + 3])};
    const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1],
                            pl[4 * kk + 3]};
    const int vo = (kk / 4) * NV * 128 + (kk % 4) * 32;
    const uint64_t bh = sm90::desc_sw128(vh + vo, 16);
    const uint64_t bl = sm90::desc_sw128(vl + vo, 16);
    sm90::WgmmaTF32RS<NV>::run(o, al, bh);
    sm90::WgmmaTF32RS<NV>::run(o, ah, bl);
    sm90::WgmmaTF32RS<NV>::run(o, ah, bh);
  }
}

struct Params {
  float* o;  // (B, H, Sq, D) view, contiguous head dim
  long long osb, osh, oss;
  float* lse;  // (B, H, Sq) fp32, the training forward only
  int H, Sq, Sk, D;
  float qscale;
};

template <int NV, bool FIXED>
__global__ void __launch_bounds__(Cfg<NV>::NTHREADS, 1)
flash_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tkh,
                       const __grid_constant__ CUtensorMap tkl,
                       const __grid_constant__ CUtensorMap tvh,
                       const __grid_constant__ CUtensorMap tvl, Params prm) {
  using L = Cfg<NV>;
  constexpr int BK = L::BK, BQ = L::BQ, NWG = L::NWG, NS = L::NS;
  constexpr int NCB = L::DP / CB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + NS;
  auto slot = [&](int i) { return smem + L::SLOT_OFF + (i % NS) * L::SLOT; };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (prm.Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;  // < NWG: consumers; NWG: producer

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4 * NWG);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread keeps the TMA loads in flight
    if constexpr (NWG == 2) sm90::reg_dealloc<24>();
    if (threadIdx.x == NWG * 128) {
      sm90::mbar_expect_tx(full_q, L::Q_BYTES);
      for (int c = 0; c < NCB; ++c)
        sm90::tma_load_4d(smem + c * BQ * 128, &tq, full_q, c * CB, q0, h, b);
      for (int i = 0; i < 2 * nk; ++i) {  // K_0, V_0, K_1, V_1, ...
        const int s = i % NS, j = i / 2;
        uint8_t* sl = slot(i);
        sm90::mbar_wait(empty + s, ((i / NS) & 1) ^ 1);
        if (i % 2 == 0) {
          sm90::mbar_expect_tx(full + s, 2 * L::K_BYTES);
          for (int c = 0; c < NCB; ++c) {
            sm90::tma_load_4d(sl + c * BK * 128, &tkh, full + s, c * CB,
                              j * BK, h, b);
            sm90::tma_load_4d(sl + L::K_BYTES + c * BK * 128, &tkl, full + s,
                              c * CB, j * BK, h, b);
          }
        } else {
          sm90::mbar_expect_tx(full + s, 2 * L::V_BYTES);
          for (int c = 0; c < BK / CB; ++c) {
            sm90::tma_load_4d(sl + c * NV * 128, &tvh, full + s,
                              j * BK + c * CB, 0, h, b);
            sm90::tma_load_4d(sl + L::V_BYTES + c * NV * 128, &tvl, full + s,
                              j * BK + c * CB, 0, h, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers
  if constexpr (NWG == 2) sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  uint8_t* qh = smem + wg * 64 * 128;  // this consumer's rows of Q_hi
  uint8_t* ql = qh + L::Q_BYTES;       // and of Q_lo

  // Q: prescale by scale*log2e in fp32, split into hi and lo
  sm90::mbar_wait(full_q, 0);
  for (int i = t; i < NCB * 64 * 8; i += 128) {  // 16-byte chunks
    const int off = (i / 512) * BQ * 128 + ((i / 8) % 64) * 128 + (i % 8) * 16;
    float4* ph4 = reinterpret_cast<float4*>(qh + off);
    float4 x = *ph4, lo;
    float* e = reinterpret_cast<float*>(&x);
    float* el = reinterpret_cast<float*>(&lo);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xs = e[k] * prm.qscale;
      const uint32_t hi = tf32_rna(xs);
      e[k] = f32(hi);
      el[k] = f32(tf32_rna(xs - f32(hi)));
    }
    *ph4 = x;
    *reinterpret_cast<float4*>(ql + off) = lo;
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + wg, 128);

  float o[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
  float s[BK / 2];     // S, then P, then P_hi's bits
  uint32_t pl[BK / 2];  // P_lo
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums
  const bool ragged = prm.Sk % BK != 0;
  auto release = [&](int i) {
    if (lane == 0) sm90::mbar_arrive(empty + i % NS);
  };

  for (int j = 0; j < nk; ++j) {
    const int ik = 2 * j, iv = 2 * j + 1;
    // S_j = Q.K_j^T
    sm90::mbar_wait(full + ik % NS, (ik / NS) & 1);
    const uint8_t* kt = slot(ik);
    sm90::wgmma_fence();
    gemm_qk<L::KS, BQ, BK>(s, qh, ql, kt, kt + L::K_BYTES);
    sm90::wgmma_commit();
    sm90::fence_regs(s);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    release(ik);

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
      for (int n = 0; n < NV / 8; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }
    }
    // P = P_hi + P_lo
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const uint32_t hi = tf32_rna(s[i]);
      pl[i] = tf32_rna(s[i] - f32(hi));
      s[i] = f32(hi);
    }

    // O += P_j.V_j
    sm90::mbar_wait(full + iv % NS, (iv / NS) & 1);
    const uint8_t* vt = slot(iv);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    gemm_pv<NV, BK>(o, s, pl, vt, vt + L::V_BYTES);
    sm90::wgmma_commit();
    sm90::fence_regs(o);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(s);
    sm90::fence_regs(pl);
    release(iv);
  }

  // epilogue: O / l from registers, rows g and g + 8 of this warp's 16
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / (FIXED ? fmaxf(l0, 1e-37f) : l0);
  const float i1 = 1.f / (FIXED ? fmaxf(l1, 1e-37f) : l1);
  const int row = q0 + wg * 64 + warp * 16 + g;
  float* ob = prm.o + b * prm.osb + h * prm.osh;
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const int col = n * 8 + 2 * qd;  // D % 8 == 0: col + 1 < D too
    if (col < prm.D) {
      if (row < prm.Sq)
        *reinterpret_cast<float2*>(ob + row * prm.oss + col) =
            make_float2(o[4 * n] * i0, o[4 * n + 1] * i0);
      if (row + 8 < prm.Sq)
        *reinterpret_cast<float2*>(ob + (row + 8) * prm.oss + col) =
            make_float2(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
    }
  }
  if (!FIXED && qd == 0) {
    float* lb = prm.lse + ((long long)b * prm.H + h) * prm.Sq;
    if (row < prm.Sq) lb[row] = m0 * LN2 + logf(l0);
    if (row + 8 < prm.Sq) lb[row + 8] = m1 * LN2 + logf(l1);
  }
}

// A (B, H, S, D) fp32 view: element (b, h, s, d) at p + b sb + h sh + s ss
// + d sd.
struct View4 {
  const float* p;
  long long sb, sh, ss, sd;
};

// The split pre-pass: keys [32 x, 32 x + 32) of one (batch, head), the head
// dim in chunks of 256 (D up to 512: flash_fwd_tf32_wide_sm90.cu's calls
// too).  K_hi, K_lo: (B, H, Sk, D); V^T_hi, V^T_lo: (B, H, D, Skp),
// position c of each group of 8 holding key pi(c) = (c % 4) * 2 + c / 4 of
// the group, zero at keys past Sk.
__global__ void __launch_bounds__(256)
split_kv_kernel(View4 k, View4 v, int H, int Sk, int Skp, int D, float* khi,
                float* klo, float* vhi, float* vlo) {
  __shared__ float vs[32][257];
  const int k0 = blockIdx.x * 32, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* K = k.p + b * k.sb + h * k.sh;
  const float* V = v.p + b * v.sb + h * v.sh;
  for (int d0 = 0; d0 < D; d0 += 256) {
    const int dn = min(D - d0, 256);
    for (int i = threadIdx.x; i < 32 * dn; i += 256) {
      const int r = i / dn, d = d0 + i % dn, key = k0 + r;
      float x = 0.f;
      if (key < Sk) {
        const float kx = __ldg(K + key * k.ss + d * k.sd);
        const uint32_t hi = tf32_rna(kx);
        const long long at = (bh * Sk + key) * D + d;
        khi[at] = f32(hi);
        klo[at] = f32(tf32_rna(kx - f32(hi)));
        x = __ldg(V + key * v.ss + d * v.sd);
      }
      vs[r][d - d0] = x;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * dn; i += 256) {
      const int d = d0 + i / 32, c = i % 32;
      if (k0 + c >= Skp) continue;
      const float x = vs[(c & ~7) | ((c & 3) * 2 + ((c >> 2) & 1))][d - d0];
      const uint32_t hi = tf32_rna(x);
      const long long at = (bh * D + d) * Skp + k0 + c;
      vhi[at] = f32(hi);
      vlo[at] = f32(tf32_rna(x - f32(hi)));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

struct Call {
  View4 q, k, v, o;
  float* lse;
  float* scratch;
  int B, H, Sq, Sk, D;
  float qscale;
};

// The pre-pass over the keys of every (batch, head) into `scratch` (K_hi,
// K_lo, V^T_hi, V^T_lo, each B H Skp D floats; Skp = Sk rounded up to 8).
cudaError_t split_kv(const View4& k, const View4& v, int B, int H, int Sk,
                     int D, float* scratch, cudaStream_t stream) {
  const int Skp = (Sk + 7) / 8 * 8;
  const long long n = (long long)B * H * Skp * D;
  split_kv_kernel<<<dim3((Skp + 31) / 32, H, B), 256, 0, stream>>>(
      k, v, H, Sk, Skp, D, scratch, scratch + n, scratch + 2 * n,
      scratch + 3 * n);
  return cudaGetLastError();
}

template <int NV, bool FIXED>
cudaError_t launch(const Call& a, cudaStream_t stream) {
  using C = Cfg<NV>;
  const int Skp = (a.Sk + 7) / 8 * 8;
  const long long n = (long long)a.B * a.H * Skp * a.D;
  float* khi = a.scratch;
  float* klo = khi + n;
  float* vhi = klo + n;
  float* vlo = vhi + n;
  const cuuint64_t B = a.B, H = a.H, D = a.D;
  const cuuint64_t qdims[4] = {D, (cuuint64_t)a.Sq, H, B};
  const long long qst[3] = {a.q.ss, a.q.sh, a.q.sb};
  const cuuint64_t kdims[4] = {D, (cuuint64_t)a.Sk, H, B};
  const long long kst[3] = {a.D, (long long)a.Sk * a.D,
                            (long long)a.H * a.Sk * a.D};
  const cuuint64_t vdims[4] = {(cuuint64_t)Skp, D, H, B};
  const long long vst[3] = {Skp, (long long)a.D * Skp,
                            (long long)a.H * a.D * Skp};
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  if (!sm90::make_map_f32(&tq, a.q.p, qdims, qst, C::BQ)
      || !sm90::make_map_f32(&tkh, khi, kdims, kst, C::BK)
      || !sm90::make_map_f32(&tkl, klo, kdims, kst, C::BK)
      || !sm90::make_map_f32(&tvh, vhi, vdims, vst, NV)
      || !sm90::make_map_f32(&tvl, vlo, vdims, vst, NV))
    return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  cudaError_t err = sm90::raise_smem(flash_tf32_sm90_kernel<NV, FIXED>,
                                     C::SMEM, raised);
  if (err != cudaSuccess) return err;
  err = split_kv(a.k, a.v, a.B, a.H, a.Sk, a.D, a.scratch, stream);
  if (err != cudaSuccess) return err;
  const Params prm{const_cast<float*>(a.o.p), a.o.sb, a.o.sh, a.o.ss, a.lse,
                   a.H, a.Sq, a.Sk, a.D, a.qscale};
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, a.B);
  flash_tf32_sm90_kernel<NV, FIXED>
      <<<grid, C::NTHREADS, C::SMEM, stream>>>(tq, tkh, tkl, tvh, tvl, prm);
  return cudaGetLastError();
}

template <bool FIXED>
int dispatch(const Call& a, cudaStream_t s) {
  if (a.D <= 40) return (int)launch<40, FIXED>(a, s);
  if (a.D <= 64) return (int)launch<64, FIXED>(a, s);
  if (a.D <= 80) return (int)launch<80, FIXED>(a, s);
  if (a.D <= 128) return (int)launch<128, FIXED>(a, s);
  if (a.D <= 160) return (int)launch<160, FIXED>(a, s);
  if (a.D <= 192) return (int)launch<192, FIXED>(a, s);
  return (int)launch<256, FIXED>(a, s);
}

}  // namespace

// The split pre-pass for flash_fwd_tf32_wide_sm90.cu (head dims up to 512):
// k and v (B, H, Sk, D) fp32 views, `kst`/`vst` their (batch, head, seq,
// dim) strides in elements.
cudaError_t sdbc_tf32_split_kv(const float* k, const long long* kst,
                               const float* v, const long long* vst, int B,
                               int H, int Sk, int D, float* scratch,
                               cudaStream_t stream) {
  return split_kv(View4{k, kst[0], kst[1], kst[2], kst[3]},
                  View4{v, vst[0], vst[1], vst[2], vst[3]}, B, H, Sk, D,
                  scratch, stream);
}

// K1-K3 (fixed = 1) and K5 (fixed = 0) in fp32: q, k, v, o (B, H, S, D)
// fp32 views, `st` holding each one's (batch, head, seq, dim) strides in
// elements in that order; D a multiple of 8 up to 256.  q: a contiguous
// head dim, the other strides multiples of 4, 16-byte aligned (TMA); k, v:
// any strides; o: a contiguous head dim, even strides, 8-byte aligned.
// `lse` a contiguous (B, H, Sq) fp32 output (fixed = 0); `scratch` a
// 16-byte aligned fp32 buffer of 4 B H Skp D floats (Skp = Sk rounded up
// to 8) that the split pre-pass fills.  Two launches (the pre-pass, the
// attention kernel); returns cudaGetLastError() after them.
extern "C" int sdbc_flash_tf32_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    void* scratch, int fixed, int B, int H,
                                    int Sq, int Sk, int D,
                                    const long long* st, float qscale,
                                    void* stream) {
  auto view = [&](const void* p, int i) {
    return View4{static_cast<const float*>(p), st[4 * i], st[4 * i + 1],
                 st[4 * i + 2], st[4 * i + 3]};
  };
  const Call a{view(q, 0), view(k, 1), view(v, 2), view(o, 3),
               static_cast<float*>(lse), static_cast<float*>(scratch),
               B, H, Sq, Sk, D, qscale};
  const bool bad_q = a.q.sd != 1 || (a.q.sb | a.q.sh | a.q.ss) % 4
                     || reinterpret_cast<uintptr_t>(q) % 16;
  const bool bad_o = a.o.sd != 1 || (a.o.sb | a.o.sh | a.o.ss) % 2
                     || reinterpret_cast<uintptr_t>(o) % 8;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 || D % 8
      || B > 65535 || H > 65535 || bad_q || bad_o || scratch == nullptr
      || reinterpret_cast<uintptr_t>(scratch) % 16
      || (!fixed && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fixed ? dispatch<true>(a, s) : dispatch<false>(a, s);
}
