// Flash-attention backward for Hopper (sm_90a) at head dims above 192 (the
// VAE's single 512-wide head), bf16, on TMA-fed wgmma: the dq kernel and the
// dk/dv kernel of the training backward.
//
// Replaces the JAX package's Pallas kernels (via flash_bwd), for head dims
// in (192, 512] (flash_bwd_sm90.cu takes those up to 192):
//   flash_bwd_dq_wide_sm90_kernel  <- sdbc_tpu/ops/flash_attention_bwd.py
//                                     _dq_kernel
//   flash_bwd_dkv_wide_sm90_kernel <- sdbc_tpu/ops/flash_attention_bwd.py
//                                     _dkv_kernel
//
// Math and inputs are flash_bwd_sm90.cu's: the caller folds qs = bf16(scale
// * q) and kl = bf16(log2e * k) and pads lse2 = lse * log2e and delta =
// rowsum(dO * O) (fp32) with zeros to whole 128-row q tiles; then
//   p = exp2(qs.kl^T - lse2),  ds0 = bf16(p * (dO.V^T - delta)),
//   dq = dq_mul * sum ds0.kl (dq_mul = scale/log2e),
//   dk = sum ds0^T.qs,  dv = sum bf16(p)^T.dO.
// Keys past Sk get p = 0 on the dq kernel's last key tile (zero-filled keys
// would give p = exp2(-lse2), which overflows where lse2 is far below 0).
// q rows past Sq arrive as zeros against the zero pad (p = 1, ds0 = 0) and
// add nothing; rows of an output past S are clipped by its TMA store.
//
// What bounds them on the H100: per score the dq kernel does 6*D tensor
// FLOPs, the dk/dv kernel 8*D, each one exp2.  At (1, 1, 4096, 512) that is
// 0.0521 and 0.0695 ms at 989 TFLOP/s; the exp2s take 4.3 us and the bytes
// under 7 us.  A 64-row resident tile streams its CTA's half of the other
// sequence from the L2: 128 FLOPs a byte for dk/dv, 96 for dq.
//
// Design:
// - At D = 512, dk and dv of a 64-key tile are 2 x 64 x 512 fp32 (256 KB,
//   an SM's whole register file) and dq of a 64-row q tile 128 KB.  So a
//   cluster of two CTAs splits the head dim: CTA r owns the columns
//   [r HC, r HC + HC) of every operand and output, HC = 16 KS = 128, 192 or
//   256 (CTA 1 gets D - HC of them: the tensor maps' zero fill pads its
//   last column block, their clipping drops its stores past D).  A block is
//   256 threads, two consumer warpgroups and no producer warp: ptxas holds
//   a 384-thread block to 168 registers a thread whatever setmaxnreg asks.
// - Per streamed tile of BT rows one consumer computes the fp32 partial S_r
//   over its CTA's columns and the other the partial dP_r, on wgmma.  Each
//   posts its partial with st.async into the peer's slot, the stores
//   completing bytes on the peer's exchange mbarrier (no memory fence on
//   the way: a releasing cluster barrier cost ~800 clocks a tile), and
//   with plain stores and an arrival into its own CTA's slot where the
//   other consumer reads it.  Every consumer forms S = S_0 + S_1 and
//   dP = dP_0 + dP_1 with one fp32 addition (the same bits in all four
//   consumers of the pair): no score product is done twice, and p and ds0
//   are identical across the pair.  Each consumer takes its own exp2s (on
//   the special-function units).  A relaxed cluster barrier a tile (every
//   thread done reading the slots) lets the next partials overwrite them.
// - dk/dv (a 64-key tile resident): consumer 0 computes dP^T_r = V_r.dO_r^T
//   and owns dk[:, half r], consumer 1 computes S^T_r = kl_r.qs_r^T and owns
//   dv[:, half r], each a 64 x HC fp32 accumulator (128 registers a thread
//   at HC = 256).  qs, dO, lse2 and delta stream through the ring.  lse2
//   and delta index the columns of S^T: each thread reads its columns from
//   the slices in shared memory.
// - dq (a 64-row q tile resident): consumer 1 computes S_r = qs_r.kl_r^T,
//   consumer 0 dP_r = dO_r.V_r^T; both form ds0, and consumer w accumulates
//   dq over its share of the CTA's column blocks (2 + 2 at HC = 256).  kl
//   and V stream through the ring.
// - The products over the sequence (dq += ds0.kl, dk += ds0^T.qs, dv +=
//   bf16(p)^T.dO) take A from registers (the score accumulators repacked to
//   bf16 fragments) and read B MN-major from the row-major tile, as
//   flash_bwd_sm90.cu does: no transposed copy exists.  The score products
//   read both operands K-major.
// - Loads: 4-D tensor maps from the caller's strides ((B, S, H, D)
//   projection views and head-major tensors alike), 128-byte swizzle, into
//   a 4-stage ring of BT = 32 rows.  Tile i + 1's partials are issued
//   before tile i's exchange is awaited, so they run under it, and so does
//   the refill: lane 0 of each warp loads one column block of tile i + 3
//   into the stage of tile i - 1 (the 8 warps release a stage on its empty
//   mbarrier).  A tile's ~10 TMA copies issued by one thread held its
//   warpgroup ~700 clocks.  Column blocks past CTA 1's width are zeroed
//   once and never loaded.
// - Epilogue: each consumer's output to bf16 in the 128-byte swizzle over a
//   resident tile it no longer reads, then TMA stores, which clip rows past
//   S and columns past the half's width.
// - Shared memory at HC = 256: the resident tiles 2 x 32 KB, the ring 4 x
//   (2 x 16 KB + 256 B of lse2/delta), the exchange slots 3 (dk/dv) or 4
//   (dq) x 8 KB, the barriers and 1 KB to align: 218.1 KB (dk/dv) and
//   225.0 KB (dq) of the 227 KB a block may have.
// - No atomics; every output element is written by one CTA; every sum runs
//   in a fixed order, so two calls give the same bits.

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::pack_bf16;
using sm90::swz;

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int BR = 64;         // resident rows: q rows (dq), keys (dk/dv)
constexpr int BT = 32;         // streamed rows per tile
constexpr int STAGES = 4;
constexpr int CB = 64;         // columns per 128-byte-swizzled column block
constexpr int X_BYTES = 128 * (BT / 2) * 4;  // one consumer's 64 x BT partial
constexpr float NEG_INF = -1e30f;

// exchange slots: this CTA's S partial, the peer's S partial, the peer's dP
// partial and (dq only) this CTA's dP partial
constexpr int X_S_LOCAL = 0, X_S_PEER = 1, X_DP_PEER = 2, X_DP_LOCAL = 3;

// The CTA's shape for KS k16 steps of the score products (its HC = 16 KS
// columns) and the kernel (DKV: dk/dv, else dq).
template <int KS, bool DKV>
struct Cfg {
  static constexpr int HC = 16 * KS;
  static constexpr int NCB = HC / CB;
  static_assert(HC % CB == 0, "a CTA's columns are whole column blocks");
  static constexpr int NCB0 = (NCB + 1) / 2;  // dq: consumer 0's blocks
  static constexpr bool KV = DKV;
  static constexpr int NMAPS = DKV ? 6 : 5;  // qs, dO, kl, V, dq | dk, dv
  static constexpr int RES_BYTES = BR * HC * 2;  // one resident tile
  static constexpr int ST_BYTES = BT * HC * 2;   // one streamed tile
  static constexpr int VEC_BYTES = DKV ? 2 * BT * 4 : 0;  // lse2, delta
  static constexpr int NX = DKV ? 3 : 4;  // exchange slots
  // bytes a tile's exchange brings from the peer (the local slots are
  // plain stores, each poster arriving on the mbarrier)
  static constexpr int XB = 2 * X_BYTES;
  static constexpr int S0_OFF = 2 * RES_BYTES;  // streamed qs (dk/dv) / kl
  static constexpr int S1_OFF = S0_OFF + STAGES * ST_BYTES;  // dO / V
  static constexpr int VEC_OFF = S1_OFF + STAGES * ST_BYTES;
  static constexpr int X_OFF = VEC_OFF + STAGES * VEC_BYTES;
  static constexpr int BAR_OFF = X_OFF + NX * X_BYTES;
  // full_r, full[STAGES], empty[STAGES], xfull; + room to align the base
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

template <int N>
struct Maps {
  CUtensorMap m[N];  // qs, dO, kl, V, dq | dk, dv
};

struct Params {
  int H, Sq, Sk, sq_pad;
  int ncb1;  // column blocks of CTA 1's columns (the rest are zero)
  float dq_mul;
  const float* lse2;   // (B, H, sq_pad) fp32, zero past Sq
  const float* delta;  // (B, H, sq_pad) fp32, zero past Sq
};

// What a CTA's consumers share.
struct Ctx {
  uint8_t* smem;
  uint64_t *full_r, *full, *empty, *xfull;
  const CUtensorMap* mp;  // the maps
  Params prm;
  int row0, h, b, rank;
  int col0;  // this CTA's first column
  int ncb;  // column blocks this CTA loads and stores
  int n;    // streamed tiles
  // shared::cluster addresses of the peer's exchange slots and mbarrier
  uint32_t peer_x, peer_bar;
};

// C (64 x BT) = A (the 64-row resident tile) . B^T (the BT-row streamed
// tile): KS k16 steps, both K-major.
template <int KS>
__device__ __forceinline__ void gemm_ss(float (&c)[BT / 2], const uint8_t* a,
                                        const uint8_t* bt) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = (ks % 4) * 32;  // k16 step inside a column block
    sm90::WgmmaSS<BT>::run(
        c, sm90::desc_sw128(a + (ks / 4) * BR * 128 + off, 16),
        sm90::desc_sw128(bt + (ks / 4) * BT * 128 + off, 16), ks > 0);
  }
}

// C (64 x NV) += X (64 x BT, bf16 A fragments) . T (BT x NV: NV columns of
// the streamed row-major tile from `tile` on, read MN-major).
template <int NV>
__device__ __forceinline__ void gemm_rs(float (&c)[NV / 2],
                                        const uint32_t (&x)[BT / 16][4],
                                        const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    sm90::WgmmaRS<NV>::run(c, x[kk], sm90::desc_sw128(tile + kk * 16 * 128,
                                                      BT * 128));
}

// bf16 A fragments of a (64 x BT) accumulator: chunks 2kk (a0: row g, a1:
// row g + 8) and 2kk + 1 (a2, a3).
__device__ __forceinline__ void pack_frags(uint32_t (&x)[BT / 16][4],
                                           const float (&c)[BT / 2]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    x[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    x[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    x[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    x[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Orders the fragments' computation (and so the reads of the slots they
// come from) before what follows, such as a relaxed cluster arrival.
__device__ __forceinline__ void fence_frags(uint32_t (&x)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[kk][e])::"memory");
}

// A (64 x NV) accumulator times `mul` to bf16 at this thread's places in a
// 64-row swizzled tile (`w`: its first column block to write).
template <int NV>
__device__ __forceinline__ void stage_out(uint8_t* w, const float (&c)[NV / 2],
                                          float mul, int r0, int qd) {
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const int col = n * 8 + 2 * qd;
    *reinterpret_cast<uint32_t*>(w + swz(r0, col, BR)) =
        pack_bf16(c[4 * n] * mul, c[4 * n + 1] * mul);
    *reinterpret_cast<uint32_t*>(w + swz(r0 + 8, col, BR)) =
        pack_bf16(c[4 * n + 2] * mul, c[4 * n + 3] * mul);
  }
}

// ---------------------------------------------------------------------------
// the exchange: thread t's BT/2 partial values as 16-byte chunks at
// t, t + 128, ... of a slot, neighbouring threads on neighbouring chunks (a
// thread of either consumer, in either CTA, holds the same places of its
// 64 x BT accumulator): st.async into the peer's slots, plain stores into
// this CTA's

__device__ __forceinline__ void post_peer(uint32_t slot, uint32_t bar,
                                          const float (&v)[BT / 2], int t) {
#pragma unroll
  for (int k = 0; k < BT / 8; ++k)
    sm90::st_async_v4(slot + (k * 128 + t) * 16, bar, v[4 * k], v[4 * k + 1],
                      v[4 * k + 2], v[4 * k + 3]);
}

// plain stores into this CTA's slot, then this thread's arrival on the
// exchange mbarrier (release: the readers' wait sees the stores)
__device__ __forceinline__ void post_local(uint8_t* slot, uint64_t* bar,
                                           const float (&v)[BT / 2], int t) {
  float4* s = reinterpret_cast<float4*>(slot);
#pragma unroll
  for (int k = 0; k < BT / 8; ++k)
    s[k * 128 + t] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                 v[4 * k + 3]);
  sm90::mbar_arrive(bar);
}

// out = a + (slot b): one fp32 addition, a the rank-independent order
// (addition commutes, so S_0 + S_1 has the same bits in both CTAs)
__device__ __forceinline__ void add_slot(float (&out)[BT / 2],
                                         const float (&a)[BT / 2],
                                         const uint8_t* slot, int t) {
  const float4* s = reinterpret_cast<const float4*>(slot);
#pragma unroll
  for (int k = 0; k < BT / 8; ++k) {
    const float4 v = s[k * 128 + t];
    out[4 * k] = __fadd_rn(a[4 * k], v.x);
    out[4 * k + 1] = __fadd_rn(a[4 * k + 1], v.y);
    out[4 * k + 2] = __fadd_rn(a[4 * k + 2], v.z);
    out[4 * k + 3] = __fadd_rn(a[4 * k + 3], v.w);
  }
}

__device__ __forceinline__ void load_slot(float (&out)[BT / 2],
                                          const uint8_t* slot, int t) {
  const float4* s = reinterpret_cast<const float4*>(slot);
#pragma unroll
  for (int k = 0; k < BT / 8; ++k) {
    const float4 v = s[k * 128 + t];
    out[4 * k] = v.x;
    out[4 * k + 1] = v.y;
    out[4 * k + 2] = v.z;
    out[4 * k + 3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// loads

// Column block `c` (of `w`'s half) of streamed tile j (rows j*BT.. of this
// CTA's columns) into stage j % STAGES: qs (w = 0) or dO (w = 1) for
// dk/dv, kl or V for dq.  Block 0 also arrives on the stage's full barrier
// with the whole half's bytes and brings, for dO, the lse2/delta slices.
template <class L>
__device__ __forceinline__ void issue(const Ctx& x, int j, int w, int c) {
  const int s = j % STAGES;
  uint64_t* bar = x.full + s;
  if (c == 0)
    sm90::mbar_expect_tx(bar, x.ncb * BT * 128 + (w ? L::VEC_BYTES : 0));
  sm90::tma_load_4d(x.smem + (w ? L::S1_OFF : L::S0_OFF) + s * L::ST_BYTES
                        + c * BT * 128,
                    x.mp + (L::KV ? 0 : 2) + w, bar, x.col0 + c * CB, j * BT,
                    x.h, x.b);
  if (c == 0 && w && L::VEC_BYTES) {
    float* vec = reinterpret_cast<float*>(x.smem + L::VEC_OFF
                                          + s * L::VEC_BYTES);
    const long long vb = ((long long)x.b * x.prm.H + x.h) * x.prm.sq_pad
                         + j * BT;
    sm90::bulk_load(vec, x.prm.lse2 + vb, BT * 4, bar);
    sm90::bulk_load(vec + BT, x.prm.delta + vb, BT * 4, bar);
  }
}

// Lane 0 of each warp of consumer w: column block `warp` of w's half of
// tile j into its stage, once the consumers have released the stage's
// previous tile (j - STAGES).
template <class L>
__device__ __forceinline__ void refill(const Ctx& x, int j, int w, int t) {
  if (t % 32 != 0 || t / 32 >= x.ncb || j >= x.n) return;
  if (j >= STAGES)
    sm90::mbar_wait(x.empty + j % STAGES, ((j - STAGES) / STAGES) & 1);
  issue<L>(x, j, w, t / 32);
}

// The CTA's set-up: its shared memory and maps, the zeroed column blocks,
// the barriers, a cluster barrier (the peer's barriers are set up before
// any store into its shared memory), then the resident tiles and the
// ring's first tiles in flight.
template <class L, class M>
__device__ __forceinline__ Ctx start(uint8_t* raw, const M& maps,
                                     const Params& prm, int nrows) {
  Ctx x;
  x.smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  x.full_r = reinterpret_cast<uint64_t*>(x.smem + L::BAR_OFF);
  x.full = x.full_r + 1;
  x.empty = x.full + STAGES;
  x.xfull = x.empty + STAGES;
  x.rank = (int)sm90::cluster_ctarank();
  x.mp = maps.m;
  x.col0 = x.rank * L::HC;
  x.prm = prm;
  x.row0 = (blockIdx.x / 2) * BR;
  x.h = blockIdx.y;
  x.b = blockIdx.z;
  x.ncb = x.rank == 0 ? L::NCB : prm.ncb1;
  x.n = (nrows + BT - 1) / BT;
  x.peer_x = sm90::peer_addr(x.smem + L::X_OFF, x.rank ^ 1);
  x.peer_bar = sm90::peer_addr(x.xfull, x.rank ^ 1);

  if (x.ncb < L::NCB) {  // CTA 1's columns end inside its column blocks
    auto zero = [&](uint8_t* tile, int rows) {
      uint4* p = reinterpret_cast<uint4*>(tile + x.ncb * rows * 128);
      const int n16 = (L::NCB - x.ncb) * rows * 8;
      for (int i = threadIdx.x; i < n16; i += NTHREADS)
        p[i] = make_uint4(0u, 0u, 0u, 0u);
    };
    zero(x.smem, BR);
    zero(x.smem + L::RES_BYTES, BR);
    for (int s = 0; s < STAGES; ++s) {
      zero(x.smem + L::S0_OFF + s * L::ST_BYTES, BT);
      zero(x.smem + L::S1_OFF + s * L::ST_BYTES, BT);
    }
    sm90::fence_proxy_async();  // the zeros, for wgmma
  }
  if (threadIdx.x == 0) {
    sm90::mbar_init(x.full_r, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(x.full + s, 2);            // a half each
      sm90::mbar_init(x.empty + s, NTHREADS / 32);  // one per warp
    }
    // the arm (one thread) and the threads posting local slots
    sm90::mbar_init(x.xfull, 1 + (L::KV ? 128 : 256));
    sm90::fence_barrier_init();
    sm90::mbar_expect_tx(x.xfull, L::XB);  // tile 0's partials
  }
  sm90::cluster_sync();
  if (threadIdx.x == 0) {
    const CUtensorMap* mr = x.mp + (L::KV ? 2 : 0);  // the resident pair
    for (int i = 0; i < 4; ++i) sm90::prefetch_tmap(x.mp + i);
    sm90::mbar_expect_tx(x.full_r, 2 * x.ncb * BR * 128);
    for (int c = 0; c < x.ncb; ++c) {
      sm90::tma_load_4d(x.smem + c * BR * 128, mr, x.full_r, x.col0 + c * CB,
                        x.row0, x.h, x.b);
      sm90::tma_load_4d(x.smem + L::RES_BYTES + c * BR * 128, mr + 1,
                        x.full_r, x.col0 + c * CB, x.row0, x.h, x.b);
    }
    for (int j = 0; j < STAGES - 1 && j < x.n; ++j)
      for (int c = 0; c < x.ncb; ++c) {
        issue<L>(x, j, 0, c);
        issue<L>(x, j, 1, c);
      }
  }
  return x;
}

// ---------------------------------------------------------------------------
// K6b: dk (consumer 0) and dv (consumer 1) over CTA r's columns of a 64-key
// tile, streaming qs and dO.  The transposed products S^T = kl.qs^T and
// dP^T = V.dO^T put p^T and ds0^T in A-fragment layout directly.

template <int KS, int W>
__device__ __forceinline__ void consume_dkv(const Ctx& x) {
  using L = Cfg<KS, true>;
  constexpr int HC = L::HC;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  // this consumer's partial: dP^T_r = V_r.dO_r^T (W = 0), S^T_r =
  // kl_r.qs_r^T (W = 1)
  const uint8_t* res = x.smem + (W == 0 ? L::RES_BYTES : 0);
  const int sb = W == 0 ? L::S1_OFF : L::S0_OFF;
  const uint8_t* xs = x.smem + L::X_OFF;

  float acc[HC / 2];  // dk (W = 0), dv (W = 1)
#pragma unroll
  for (int i = 0; i < HC / 2; ++i) acc[i] = 0.f;
  float part[BT / 2], nxt[BT / 2], s[BT / 2];
  uint32_t frag[BT / 16][4];

  // issues this consumer's partial of tile i (asynchronous)
  auto partial = [&](float (&c)[BT / 2], int i) {
    const int st = i % STAGES;
    sm90::mbar_wait(x.full + st, (i / STAGES) & 1);
    sm90::wgmma_fence();
    gemm_ss<KS>(c, res, x.smem + sb + st * L::ST_BYTES);
    sm90::wgmma_commit();
    sm90::fence_regs(c);
  };
  // S^T_r to both CTAs' slots, dP^T_r to the peer's
  auto post_part = [&](const float (&c)[BT / 2]) {
    if (W == 1) {
      post_peer(x.peer_x + X_S_PEER * X_BYTES, x.peer_bar, c, t);
      post_local(x.smem + L::X_OFF + X_S_LOCAL * X_BYTES, x.xfull, c, t);
    } else {
      post_peer(x.peer_x + X_DP_PEER * X_BYTES, x.peer_bar, c, t);
    }
  };

  sm90::mbar_wait(x.full_r, 0);
  partial(part, 0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(part);
  post_part(part);
  for (int i = 0; i < x.n; ++i) {
    const int st = i % STAGES;
    const bool next = i + 1 < x.n;
    // tile i + 1's partial runs while tile i's exchange completes
    if (next) partial(nxt, i + 1);
    refill<L>(x, i + STAGES - 1, W, t);  // into the stage of tile i - 1
    sm90::mbar_wait_cluster(x.xfull, i & 1);  // tile i's partials landed
    if (W == 0 && t == 0 && next)
      sm90::mbar_expect_tx(x.xfull, L::XB);  // tile i + 1's

    const uint8_t* qt = x.smem + L::S0_OFF + st * L::ST_BYTES;
    const uint8_t* dot = x.smem + L::S1_OFF + st * L::ST_BYTES;
    const float* lv = reinterpret_cast<const float*>(x.smem + L::VEC_OFF
                                                     + st * L::VEC_BYTES);
    const float* dlv = lv + BT;
    // p^T: column c of S^T is q row c of the tile
    if (W == 1) {
      add_slot(s, part, xs + X_S_PEER * X_BYTES, t);
    } else {
      load_slot(s, xs + X_S_LOCAL * X_BYTES, t);
      add_slot(s, s, xs + X_S_PEER * X_BYTES, t);
    }
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lv + n * 8 + 2 * qd);
      s[4 * n] = ex2(s[4 * n] - l.x);
      s[4 * n + 1] = ex2(s[4 * n + 1] - l.y);
      s[4 * n + 2] = ex2(s[4 * n + 2] - l.x);
      s[4 * n + 3] = ex2(s[4 * n + 3] - l.y);
    }
    if (W == 0) {  // ds0^T = p^T * (dP^T - delta)
      add_slot(part, part, xs + X_DP_PEER * X_BYTES, t);
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
        const float2 d = *reinterpret_cast<const float2*>(dlv + n * 8
                                                          + 2 * qd);
        part[4 * n] = s[4 * n] * (part[4 * n] - d.x);
        part[4 * n + 1] = s[4 * n + 1] * (part[4 * n + 1] - d.y);
        part[4 * n + 2] = s[4 * n + 2] * (part[4 * n + 2] - d.x);
        part[4 * n + 3] = s[4 * n + 3] * (part[4 * n + 3] - d.y);
      }
      pack_frags(frag, part);
    } else {
      pack_frags(frag, s);
    }
    fence_frags(frag);
    sm90::cluster_arrive_relaxed();  // this thread is done with the slots
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    gemm_rs<HC>(acc, frag, W == 0 ? qt : dot);  // dk += ds0^T.qs, dv += p^T.dO
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    sm90::wgmma_wait<0>();  // tile i + 1's partial and tile i's product
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(x.empty + st);  // the stage is free
    sm90::cluster_wait();  // every thread of the pair is done with the slots
    if (next) {
      sm90::fence_regs(nxt);
      post_part(nxt);
#pragma unroll
      for (int k = 0; k < BT / 2; ++k) part[k] = nxt[k];
    }
  }

  // dk over kl, dv over V: their last readers finished before the last
  // cluster barrier
  uint8_t* out = x.smem + (W == 0 ? 0 : L::RES_BYTES);
  stage_out<HC>(out, acc, 1.f, warp * 16 + g, qd);
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + W, 128);
  if (t == 0) {
    for (int c = 0; c < x.ncb; ++c)
      sm90::tma_store_4d(x.mp + 4 + W, out + c * BR * 128, x.col0 + c * CB,
                         x.row0, x.h, x.b);
    sm90::tma_store_commit_and_wait();
  }
}

template <int KS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ Maps<6> maps,
                               const Params prm) {
  using L = Cfg<KS, true>;
  extern __shared__ uint8_t smem_raw[];
  const Ctx x = start<L>(smem_raw, maps, prm, prm.Sq);
  if (threadIdx.x < 128)
    consume_dkv<KS, 0>(x);
  else
    consume_dkv<KS, 1>(x);
}

// ---------------------------------------------------------------------------
// K6a: dq over CTA r's columns of a 64-row q tile, streaming kl and V.
// Consumer w accumulates the column blocks [CB0, CB0 + NV / 64).

template <int KS, int W>
__device__ __forceinline__ void consume_dq(const Ctx& x) {
  using L = Cfg<KS, false>;
  constexpr int CB0 = W == 0 ? 0 : L::NCB0;
  constexpr int NV = (W == 0 ? L::NCB0 : L::NCB - L::NCB0) * CB;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, qd = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  // this consumer's partial: dP_r = dO_r.V_r^T (W = 0), S_r = qs_r.kl_r^T
  // (W = 1)
  const uint8_t* res = x.smem + (W == 0 ? L::RES_BYTES : 0);
  const int sb = W == 0 ? L::S1_OFF : L::S0_OFF;
  const uint8_t* xs = x.smem + L::X_OFF;
  const long long vrow = ((long long)x.b * x.prm.H + x.h) * x.prm.sq_pad
                         + x.row0 + r0;
  const float lse0 = x.prm.lse2[vrow], lse1 = x.prm.lse2[vrow + 8];
  const float dl0 = x.prm.delta[vrow], dl1 = x.prm.delta[vrow + 8];
  const bool ragged = x.prm.Sk % BT != 0;

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  float part[BT / 2], nxt[BT / 2], s[BT / 2], dp[BT / 2];
  uint32_t frag[BT / 16][4];

  auto partial = [&](float (&c)[BT / 2], int j) {
    const int st = j % STAGES;
    sm90::mbar_wait(x.full + st, (j / STAGES) & 1);
    sm90::wgmma_fence();
    gemm_ss<KS>(c, res, x.smem + sb + st * L::ST_BYTES);
    sm90::wgmma_commit();
    sm90::fence_regs(c);
  };
  // S_r (W = 1) or dP_r (W = 0) to both CTAs' slots
  auto post_part = [&](const float (&c)[BT / 2]) {
    const int local = W == 1 ? X_S_LOCAL : X_DP_LOCAL;
    const int remote = W == 1 ? X_S_PEER : X_DP_PEER;
    post_peer(x.peer_x + remote * X_BYTES, x.peer_bar, c, t);
    post_local(x.smem + L::X_OFF + local * X_BYTES, x.xfull, c, t);
  };

  sm90::mbar_wait(x.full_r, 0);
  partial(part, 0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(part);
  post_part(part);
  for (int j = 0; j < x.n; ++j) {
    const int st = j % STAGES;
    const bool next = j + 1 < x.n;
    if (next) partial(nxt, j + 1);
    refill<L>(x, j + STAGES - 1, W, t);  // into the stage of tile j - 1
    sm90::mbar_wait_cluster(x.xfull, j & 1);  // tile j's partials landed
    if (W == 0 && t == 0 && next)
      sm90::mbar_expect_tx(x.xfull, L::XB);  // tile j + 1's

    const uint8_t* kt = x.smem + L::S0_OFF + st * L::ST_BYTES;
    if (W == 1) {
      add_slot(s, part, xs + X_S_PEER * X_BYTES, t);
      load_slot(dp, xs + X_DP_LOCAL * X_BYTES, t);
      add_slot(dp, dp, xs + X_DP_PEER * X_BYTES, t);
    } else {
      load_slot(s, xs + X_S_LOCAL * X_BYTES, t);
      add_slot(s, s, xs + X_S_PEER * X_BYTES, t);
      add_slot(dp, part, xs + X_DP_PEER * X_BYTES, t);
    }
    if (ragged && j == x.n - 1) {
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
        const int col = j * BT + n * 8 + 2 * qd;
        if (col >= x.prm.Sk) s[4 * n] = s[4 * n + 2] = NEG_INF;
        if (col + 1 >= x.prm.Sk) s[4 * n + 1] = s[4 * n + 3] = NEG_INF;
      }
    }
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      dp[4 * n] = ex2(s[4 * n] - lse0) * (dp[4 * n] - dl0);
      dp[4 * n + 1] = ex2(s[4 * n + 1] - lse0) * (dp[4 * n + 1] - dl0);
      dp[4 * n + 2] = ex2(s[4 * n + 2] - lse1) * (dp[4 * n + 2] - dl1);
      dp[4 * n + 3] = ex2(s[4 * n + 3] - lse1) * (dp[4 * n + 3] - dl1);
    }
    pack_frags(frag, dp);
    fence_frags(frag);
    sm90::cluster_arrive_relaxed();  // this thread is done with the slots
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    gemm_rs<NV>(acc, frag, kt + CB0 * BT * 128);  // dq += ds0.kl
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    sm90::wgmma_wait<0>();  // tile j + 1's partial and tile j's product
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(x.empty + st);  // the stage is free
    sm90::cluster_wait();  // every thread of the pair is done with the slots
    if (next) {
      sm90::fence_regs(nxt);
      post_part(nxt);
#pragma unroll
      for (int k = 0; k < BT / 2; ++k) part[k] = nxt[k];
    }
  }

  // dq over the qs tile (its reader finished before the last cluster
  // barrier), this consumer's column blocks
  uint8_t* out = x.smem + CB0 * BR * 128;
  stage_out<NV>(out, acc, x.prm.dq_mul, r0, qd);
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + W, 128);
  if (t == 0) {
    for (int c = CB0; c < CB0 + NV / CB && c < x.ncb; ++c)
      sm90::tma_store_4d(x.mp + 4, x.smem + c * BR * 128, x.col0 + c * CB,
                         x.row0, x.h, x.b);
    sm90::tma_store_commit_and_wait();
  }
}

template <int KS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ Maps<5> maps,
                              const Params prm) {
  using L = Cfg<KS, false>;
  extern __shared__ uint8_t smem_raw[];
  const Ctx x = start<L>(smem_raw, maps, prm, prm.Sk);
  if (threadIdx.x < 128)
    consume_dq<KS, 0>(x);
  else
    consume_dq<KS, 1>(x);
}

// ---------------------------------------------------------------------------
// host side: tensor maps (sm90.cuh) and launch

using sm90::View;

struct Args {
  View qs, dout, kl, v, o0, o1;  // o0: dq or dk, o1: dv
  const float *lse2, *delta;
  int B, H, Sq, Sk, D, sq_pad;
  float dq_mul;
  cudaStream_t stream;
};

template <int KS, bool DKV>
cudaError_t launch(const Args& a) {
  using L = Cfg<KS, DKV>;
  constexpr int HC = L::HC;
  Maps<L::NMAPS> maps;
  const View* ops[6] = {&a.qs, &a.dout, &a.kl, &a.v, &a.o0, &a.o1};
  const int seq[6] = {a.Sq, a.Sq, a.Sk, a.Sk, DKV ? a.Sk : a.Sq, a.Sk};
  const int rows[6] = {DKV ? BT : BR, DKV ? BT : BR, DKV ? BR : BT,
                       DKV ? BR : BT, BR, BR};
  for (int i = 0; i < L::NMAPS; ++i)
    if (!sm90::make_map(&maps.m[i], *ops[i], a.B, seq[i], a.H, a.D, rows[i]))
      return cudaErrorInvalidValue;
  const int ncb1 = (a.D - HC + CB - 1) / CB;
  const Params prm{a.H, a.Sq, a.Sk, a.sq_pad, ncb1 < L::NCB ? ncb1 : L::NCB,
                   a.dq_mul, a.lse2, a.delta};
  // a cluster of two CTAs per resident tile
  dim3 grid(2 * (((DKV ? a.Sk : a.Sq) + BR - 1) / BR), a.H, a.B);
  static uint64_t raised = 0;
  cudaError_t err;
  if constexpr (DKV) {
    err = sm90::raise_smem(flash_bwd_dkv_wide_sm90_kernel<KS>, L::SMEM,
                           raised);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wide_sm90_kernel<KS>
        <<<grid, NTHREADS, L::SMEM, a.stream>>>(maps, prm);
  } else {
    err = sm90::raise_smem(flash_bwd_dq_wide_sm90_kernel<KS>, L::SMEM,
                           raised);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wide_sm90_kernel<KS>
        <<<grid, NTHREADS, L::SMEM, a.stream>>>(maps, prm);
  }
  return cudaGetLastError();
}

// The instantiations: a CTA's columns HC = 128, 192 or 256, the least that
// leaves CTA 1 no more than CTA 0.
template <bool DKV>
int dispatch(const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.D <= 192
      || a.D > 512 || a.D % 8 || a.B > 65535 || a.H > 65535
      || a.sq_pad % 128 || a.sq_pad < a.Sq)
    return (int)cudaErrorInvalidValue;
  if (a.D <= 256) return (int)launch<8, DKV>(a);
  if (a.D <= 384) return (int)launch<12, DKV>(a);
  return (int)launch<16, DKV>(a);
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

// K6 for D in (192, 512], a multiple of 8; arguments as
// sdbc_flash_bwd_dq_sm90 / sdbc_flash_bwd_dkv_sm90 (flash_bwd_sm90.cu):
// qs, kl, v, dout and the outputs bf16 with (batch, head, seq) strides in
// elements (`st`, three per tensor in argument order; multiples of 8), a
// contiguous head dim, 16-byte aligned; lse2 and delta contiguous
// (B, H, sq_pad) fp32, zero past Sq, sq_pad a multiple of 128.  Each returns
// cudaGetLastError() after its launch.
extern "C" int sdbc_flash_bwd_dq_wide_sm90(const void* qs, const void* kl,
                                           const void* v, const void* dout,
                                           const void* lse2,
                                           const void* delta, void* dq,
                                           int B, int H, int Sq, int Sk,
                                           int D, int sq_pad,
                                           const long long* st, float dq_mul,
                                           void* stream) {
  Args a = args(qs, kl, v, dout, lse2, delta, B, H, Sq, Sk, D, sq_pad, st,
                stream);
  a.o0 = View{dq, st[12], st[14], st[13]};
  a.dq_mul = dq_mul;
  return dispatch<false>(a);
}

extern "C" int sdbc_flash_bwd_dkv_wide_sm90(const void* qs, const void* kl,
                                            const void* v, const void* dout,
                                            const void* lse2,
                                            const void* delta, void* dk,
                                            void* dv, int B, int H, int Sq,
                                            int Sk, int D, int sq_pad,
                                            const long long* st,
                                            void* stream) {
  Args a = args(qs, kl, v, dout, lse2, delta, B, H, Sq, Sk, D, sq_pad, st,
                stream);
  a.o0 = View{dk, st[12], st[14], st[13]};
  a.o1 = View{dv, st[15], st[17], st[16]};
  return dispatch<true>(a);
}
