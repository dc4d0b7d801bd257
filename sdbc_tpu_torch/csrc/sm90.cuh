// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tensor loads
// and stores, named barriers, warpgroup register reallocation, cluster
// barriers and distributed shared memory, and the wgmma products with their
// shared-memory descriptors; on the host, the 4-D tensor maps of
// (B, S, H, D) and head-dim-major views and maps of any rank.  Used by
// flash_fwd_sm90.cu, flash_fwd_wide_sm90.cu, flash_fwd_tf32_sm90.cu,
// flash_fwd_tf32_wide_sm90.cu, flash_bwd_sm90.cu, flash_bwd_wide_sm90.cu,
// flash_bwd_tf32_sm90.cu, flash_int8_sm90.cu, geglu_ff_sm90.cu,
// geglu_ff_tf32_sm90.cu and group_norm_sm90.cu.
//
// Layout convention: every operand tile in shared memory is a stack of
// "column blocks", each R rows of 64 bf16 (128 bytes) in the 128-byte
// swizzle that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8)); a column block starts on a
// 1024-byte boundary.  wgmma reads the same layout through a descriptor of
// layout type 1 (128B swizzle).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// small arithmetic of the attention and feed-forward kernels

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The max and the sum over the four lanes of a quad (the threads that hold
// one row of an m64 accumulator fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of (row, col) in a stack of 64-column blocks of `rows` rows,
// 128-byte swizzle (col even: a bf16 pair never straddles a 16-byte chunk).
__device__ __forceinline__ int swz(int row, int col, int rows) {
  const int cb = col / 64, cc = col % 64;
  return cb * rows * 128 + row * 128 + ((((cc >> 3) ^ row) & 7) << 4)
         + (cc & 7) * 2;
}

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// Blocks until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as completed, parity 1).  A wait that
// never ends (a lost arrival) traps after ~2^28 polls instead of hanging
// the device, so the launch fails with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// The same wait with acquire semantics at cluster scope: for a barrier whose
// phase completes on bytes that another CTA of the cluster stored (st_async).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA (4-D tensor maps; coordinates innermost first)

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Fetches a tensor map into the TMA unit's cache ahead of its first use.
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
      "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 2-D loads and stores (coordinates innermost first).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) of the threads that synchronise after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// named barriers and register reallocation

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// thread block clusters: the CTA's rank, the cluster-wide barrier and stores
// into a peer CTA's shared memory (distributed shared memory)

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it, local or remote, are visible
// after it, and no CTA of the cluster has exited while it waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The two halves of cluster_sync: a relaxed arrival (no memory ordering:
// only "this CTA has started") and the wait for every CTA's arrival.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this CTA's shared memory) in the
// shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer_v4(uint32_t addr, float a, float b,
                                           float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

__device__ __forceinline__ void st_peer_f32(uint32_t addr, float a) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(a)
               : "memory");
}

__device__ __forceinline__ void st_peer_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// An asynchronous 16-byte store into the shared memory of a CTA of the
// cluster (`addr`, a shared::cluster address, this CTA's own included) that
// completes 16 bytes of transactions on the mbarrier `bar` of the same CTA:
// no fence, the waiter on `bar` sees the data (mbar_wait_cluster).
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint32_t bar,
                                            float a, float b, float c,
                                            float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (rows of 64-element column blocks, the contraction along the row): LBO
// unused, SBO = 1024 (8 rows of 128 bytes); the k16 steps inside a column
// block advance the start address by 32 bytes.  MN-major operands (the
// contraction down the rows, N along the row): LBO = the byte distance
// between 64-wide column blocks, SBO = 1024 (8 rows of the contraction).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The same for operands in the 64-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_64B: rows of 32 bf16, the 16-byte chunk c of row r
// at chunk c ^ ((r / 2) % 4), 512-byte aligned blocks).  MN-major: LBO =
// the byte distance between 32-wide column blocks, SBO = 512 (8 rows).
__device__ __forceinline__ uint64_t desc_sw64(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Operand lists: "%0, ..., %n-1" and the matching "+f" accumulator
// constraints, in groups of 8 registers.
#define SM90_R8(a, b, c, d, e, f, g, h) \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define SM90_REGS32                                                 \
  SM90_R8(0, 1, 2, 3, 4, 5, 6, 7) ", " SM90_R8(8, 9, 10, 11, 12, 13, 14, 15) \
  ", " SM90_R8(16, 17, 18, 19, 20, 21, 22, 23) ", "                 \
  SM90_R8(24, 25, 26, 27, 28, 29, 30, 31)
#define SM90_REGS64                                                   \
  SM90_REGS32 ", " SM90_R8(32, 33, 34, 35, 36, 37, 38, 39) ", "       \
  SM90_R8(40, 41, 42, 43, 44, 45, 46, 47) ", "                        \
  SM90_R8(48, 49, 50, 51, 52, 53, 54, 55) ", "                        \
  SM90_R8(56, 57, 58, 59, 60, 61, 62, 63)
#define SM90_REGS96                                                   \
  SM90_REGS64 ", " SM90_R8(64, 65, 66, 67, 68, 69, 70, 71) ", "       \
  SM90_R8(72, 73, 74, 75, 76, 77, 78, 79) ", "                        \
  SM90_R8(80, 81, 82, 83, 84, 85, 86, 87) ", "                        \
  SM90_R8(88, 89, 90, 91, 92, 93, 94, 95)
#define SM90_REGS128                                                  \
  SM90_REGS96 ", " SM90_R8(96, 97, 98, 99, 100, 101, 102, 103) ", "   \
  SM90_R8(104, 105, 106, 107, 108, 109, 110, 111) ", "                \
  SM90_R8(112, 113, 114, 115, 116, 117, 118, 119) ", "                \
  SM90_R8(120, 121, 122, 123, 124, 125, 126, 127)

#define SM90_REGS16 \
  SM90_R8(0, 1, 2, 3, 4, 5, 6, 7) ", " SM90_R8(8, 9, 10, 11, 12, 13, 14, 15)
#define SM90_REGS24                                                 \
  SM90_R8(0, 1, 2, 3, 4, 5, 6, 7) ", " SM90_R8(8, 9, 10, 11, 12, 13, 14, 15) \
  ", " SM90_R8(16, 17, 18, 19, 20, 21, 22, 23)
#define SM90_REGS40 SM90_REGS32 ", " SM90_R8(32, 33, 34, 35, 36, 37, 38, 39)
#define SM90_REGS80                                                   \
  SM90_REGS64 ", " SM90_R8(64, 65, 66, 67, 68, 69, 70, 71) ", "       \
  SM90_R8(72, 73, 74, 75, 76, 77, 78, 79)

#define SM90_F8(d, o)                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define SM90_F32(d, o) \
  SM90_F8(d, o), SM90_F8(d, o + 8), SM90_F8(d, o + 16), SM90_F8(d, o + 24)
#define SM90_F16(d) SM90_F8(d, 0), SM90_F8(d, 8)
#define SM90_F24(d) SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16)
#define SM90_F40(d) SM90_F32(d, 0), SM90_F8(d, 32)
#define SM90_F64(d) SM90_F32(d, 0), SM90_F32(d, 32)
#define SM90_F80(d) SM90_F64(d), SM90_F8(d, 64), SM90_F8(d, 72)
#define SM90_F96(d) SM90_F64(d), SM90_F32(d, 64)
#define SM90_F128(d) SM90_F64(d), SM90_F32(d, 64), SM90_F32(d, 96)

// D (64 x N, fp32) (+)= A (64 x 16, shared, K-major) . B (16 x N, shared,
// K-major); scale_d = 0 overwrites D.
template <int N>
struct WgmmaSS;

#define SM90_SS(N, REGS, FN, IA, IB, IS)                                    \
  template <>                                                              \
  struct WgmmaSS<N> {                                                      \
    __device__ __forceinline__ static void run(float (&d)[N / 2],          \
                                               uint64_t a, uint64_t b,     \
                                               int scale_d) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k16.f32.bf16.bf16 {" REGS "}, %" #IA ", %" #IB         \
                   ", p, 1, 1, 0, 0;\n}\n"                                 \
                   : FN(d)                                                 \
                   : "l"(a), "l"(b), "r"(scale_d));                        \
    }                                                                      \
  };
#define SM90_F32_0(d) SM90_F32(d, 0)
SM90_SS(32, SM90_REGS16, SM90_F16, 16, 17, 18)
SM90_SS(64, SM90_REGS32, SM90_F32_0, 32, 33, 34)
SM90_SS(128, SM90_REGS64, SM90_F64, 64, 65, 66)

// D (64 x N, fp32) (+)= A (64 x 16, shared, MN-major: the 64 rows along
// a 128-byte row, the contraction down the rows) . B (16 x N, shared,
// MN-major as WgmmaRS reads B): both operands read transposed;
// scale_d = 0 overwrites D.
template <int N>
struct WgmmaSStt;

#define SM90_SSTT(N, REGS, FN, IA, IB, IS)                                  \
  template <>                                                              \
  struct WgmmaSStt<N> {                                                    \
    __device__ __forceinline__ static void run(float (&d)[N / 2],          \
                                               uint64_t a, uint64_t b,     \
                                               int scale_d) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k16.f32.bf16.bf16 {" REGS "}, %" #IA ", %" #IB         \
                   ", p, 1, 1, 1, 1;\n}\n"                                 \
                   : FN(d)                                                 \
                   : "l"(a), "l"(b), "r"(scale_d));                        \
    }                                                                      \
  };
SM90_SSTT(32, SM90_REGS16, SM90_F16, 16, 17, 18)
SM90_SSTT(64, SM90_REGS32, SM90_F32_0, 32, 33, 34)
SM90_SSTT(128, SM90_REGS64, SM90_F64, 64, 65, 66)

// D (64 x N, fp32) += A (64 x 16, bf16 registers in the m16n8k16 A layout
// of each warp's 16 rows) . B (16 x N, shared, MN-major: transposed read;
// N need not fill the last 64-wide column block).
template <int N>
struct WgmmaRS;

// WgmmaRSk: the same with B K-major (the contraction along the row, as
// WgmmaSS reads it).
template <int N>
struct WgmmaRSk;

#define SM90_RS(NAME, TB, N, REGS, FN, A0, A1, A2, A3, IB, IS)               \
  template <>                                                              \
  struct NAME<N> {                                                         \
    __device__ __forceinline__ static void run(float (&d)[N / 2],          \
                                               const uint32_t (&a)[4],     \
                                               uint64_t b) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k16.f32.bf16.bf16 {" REGS "}, {%" #A0 ", %" #A1        \
                   ", %" #A2 ", %" #A3 "}, %" #IB ", p, 1, 1, " #TB        \
                   ";\n}\n"                                                \
                   : FN(d)                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),   \
                     "r"(1));                                              \
    }                                                                      \
  };
#define SM90_RS_BOTH(...) \
  SM90_RS(WgmmaRS, 1, __VA_ARGS__) SM90_RS(WgmmaRSk, 0, __VA_ARGS__)
SM90_RS_BOTH(48, SM90_REGS24, SM90_F24, 24, 25, 26, 27, 28, 29)
SM90_RS_BOTH(64, SM90_REGS32, SM90_F32_0, 32, 33, 34, 35, 36, 37)
SM90_RS_BOTH(80, SM90_REGS40, SM90_F40, 40, 41, 42, 43, 44, 45)
SM90_RS_BOTH(128, SM90_REGS64, SM90_F64, 64, 65, 66, 67, 68, 69)
SM90_RS_BOTH(160, SM90_REGS80, SM90_F80, 80, 81, 82, 83, 84, 85)
SM90_RS_BOTH(192, SM90_REGS96, SM90_F96, 96, 97, 98, 99, 100, 101)
SM90_RS_BOTH(256, SM90_REGS128, SM90_F128, 128, 129, 130, 131, 132, 133)

// D (64 x N, fp32) (+)= A (64 x 16, shared, K-major) . B (16 x N, shared,
// MN-major: N along the rows of 64-column blocks, read transposed as
// WgmmaRS reads B); scale_d = 0 overwrites D.
template <int N>
struct WgmmaSSt;

#define SM90_SST(N, REGS, FN, IA, IB, IS)                                   \
  template <>                                                              \
  struct WgmmaSSt<N> {                                                     \
    __device__ __forceinline__ static void run(float (&d)[N / 2],          \
                                               uint64_t a, uint64_t b,     \
                                               int scale_d) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k16.f32.bf16.bf16 {" REGS "}, %" #IA ", %" #IB         \
                   ", p, 1, 1, 0, 1;\n}\n"                                 \
                   : FN(d)                                                 \
                   : "l"(a), "l"(b), "r"(scale_d));                        \
    }                                                                      \
  };
SM90_SST(64, SM90_REGS32, SM90_F32_0, 32, 33, 34)
SM90_SST(192, SM90_REGS96, SM90_F96, 96, 97, 98)
SM90_SST(256, SM90_REGS128, SM90_F128, 128, 129, 130)

// D (64 x N, s32) (+)= A (64 x 32, s8, shared, K-major) . B (32 x N, s8,
// shared, K-major): the integer product takes both operands K-major, with
// no transpose; a k32 step is 32 bytes, as a bf16 k16 step, so the
// descriptors are WgmmaSS's.  scale_d = 0 overwrites D.  The s32
// accumulator has the f32 one's fragment layout.
template <int N>
struct WgmmaS8;

#define SM90_I8(d, o)                                                  \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),          \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])
#define SM90_I32(d) SM90_I8(d, 0), SM90_I8(d, 8), SM90_I8(d, 16), SM90_I8(d, 24)
#define SM90_I64(d)                                                    \
  SM90_I8(d, 0), SM90_I8(d, 8), SM90_I8(d, 16), SM90_I8(d, 24),        \
      SM90_I8(d, 32), SM90_I8(d, 40), SM90_I8(d, 48), SM90_I8(d, 56)

#define SM90_S8(N, REGS, FN, IA, IB, IS)                                    \
  template <>                                                              \
  struct WgmmaS8<N> {                                                      \
    __device__ __forceinline__ static void run(uint32_t (&d)[N / 2],       \
                                               uint64_t a, uint64_t b,     \
                                               int scale_d) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k32.s32.s8.s8 {" REGS "}, %" #IA ", %" #IB ", p;\n}\n"  \
                   : FN(d)                                                 \
                   : "l"(a), "l"(b), "r"(scale_d));                        \
    }                                                                      \
  };
SM90_S8(64, SM90_REGS32, SM90_I32, 32, 33, 34)
SM90_S8(128, SM90_REGS64, SM90_I64, 64, 65, 66)

// tf32 products (m64nNk8): D (64 x N, fp32) (+)= A (64 x 8) . B (8 x N),
// both operands K-major (tf32 offers no transposed read).  A k8 step is 8
// fp32 words, 32 bytes, as a bf16 k16 step, so a 128-byte swizzled row
// holds 32 of them and the descriptors are WgmmaSS's.  The operands are
// read as tf32: the low 13 mantissa bits are ignored, so the callers round
// (cvt.rna.tf32.f32) first.  WgmmaTF32SS: A from shared memory, scale_d = 0
// overwrites D; WgmmaTF32RS: A from registers, the m16n8k8 tf32 layout of
// each warp's 16 rows (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); g = lane / 4, t = lane % 4), accumulating.
template <int N>
struct WgmmaTF32SS;

#define SM90_TF32SS(N, REGS, FN, IA, IB, IS)                                \
  template <>                                                              \
  struct WgmmaTF32SS<N> {                                                  \
    __device__ __forceinline__ static void run(float (&d)[N / 2],          \
                                               uint64_t a, uint64_t b,     \
                                               int scale_d) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k8.f32.tf32.tf32 {" REGS "}, %" #IA ", %" #IB          \
                   ", p, 1, 1;\n}\n"                                       \
                   : FN(d)                                                 \
                   : "l"(a), "l"(b), "r"(scale_d));                        \
    }                                                                      \
  };
#define SM90_REGS8 SM90_R8(0, 1, 2, 3, 4, 5, 6, 7)
#define SM90_F8_0(d) SM90_F8(d, 0)
SM90_TF32SS(16, SM90_REGS8, SM90_F8_0, 8, 9, 10)
SM90_TF32SS(32, SM90_REGS16, SM90_F16, 16, 17, 18)
SM90_TF32SS(64, SM90_REGS32, SM90_F32_0, 32, 33, 34)

template <int N>
struct WgmmaTF32RS;

#define SM90_TF32RS(N, REGS, FN, A0, A1, A2, A3, IB, IS)                    \
  template <>                                                              \
  struct WgmmaTF32RS<N> {                                                  \
    __device__ __forceinline__ static void run(float (&d)[N / 2],          \
                                               const uint32_t (&a)[4],     \
                                               uint64_t b) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k8.f32.tf32.tf32 {" REGS "}, {%" #A0 ", %" #A1         \
                   ", %" #A2 ", %" #A3 "}, %" #IB ", p, 1, 1;\n}\n"        \
                   : FN(d)                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),   \
                     "r"(1));                                              \
    }                                                                      \
  };
#define SM90_REGS20 SM90_REGS16 ", %16, %17, %18, %19"
#define SM90_F20(d) \
  SM90_F16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
SM90_TF32RS(32, SM90_REGS16, SM90_F16, 16, 17, 18, 19, 20, 21)
SM90_TF32RS(40, SM90_REGS20, SM90_F20, 20, 21, 22, 23, 24, 25)
SM90_TF32RS(64, SM90_REGS32, SM90_F32_0, 32, 33, 34, 35, 36, 37)
SM90_TF32RS(80, SM90_REGS40, SM90_F40, 40, 41, 42, 43, 44, 45)
SM90_TF32RS(128, SM90_REGS64, SM90_F64, 64, 65, 66, 67, 68, 69)
SM90_TF32RS(160, SM90_REGS80, SM90_F80, 80, 81, 82, 83, 84, 85)
SM90_TF32RS(192, SM90_REGS96, SM90_F96, 96, 97, 98, 99, 100, 101)
SM90_TF32RS(256, SM90_REGS128, SM90_F128, 128, 129, 130, 131, 132, 133)

// x rounded to tf32 (to nearest, ties away from zero), as an fp32 word
// with the low 13 mantissa bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

#undef SM90_TF32SS
#undef SM90_TF32RS
#undef SM90_S8
#undef SM90_SS
#undef SM90_SST
#undef SM90_SSTT
#undef SM90_RS
#undef SM90_RS_BOTH

// ---------------------------------------------------------------------------
// host side: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no -lcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

struct View {  // a (B, S, H, D) logical view: strides in elements
  const void* p;
  long long sb, ss, sh;
};

// A 4-D (D, S, H, B) map of `v` with boxes of 64 head-dim columns by `rows`
// sequence rows, 128-byte swizzle; reads past the bounds give zeros, stores
// past them are dropped.  A dimension of size 1 is never stepped, so its
// stride is replaced by a valid one.
inline bool make_map(CUtensorMap* map, const View& v, int B, int S, int H,
                     int D, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  auto bytes = [](long long stride, int size) {
    return (cuuint64_t)(size == 1 ? 16 : stride * 2);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(v.ss, S), bytes(v.sh, H),
                                 bytes(v.sb, B)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(v.p),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of rank `rank` (bf16 unless `dtype` says otherwise; dims and box
// innermost first, `strides` the byte strides of dims 1..rank-1), 128-byte
// swizzle unless `swizzle` says
// otherwise (a box row narrower than the swizzle is not packed densely:
// each takes a whole swizzle-wide row); reads past the bounds give zeros,
// stores past them are dropped.
inline bool make_map_nd(CUtensorMap* map, const void* p, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                        CUtensorMapDataType dtype =
                            CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return enc(map, dtype, rank, const_cast<void*>(p),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D (S, D, H, B) map of a head-dim-major view (`v.ss`: the stride of a
// head-dim row, the sequence contiguous) with boxes of `cols` positions by
// `rows` head-dim rows; rows past D and positions past S read as zeros,
// stores past them are dropped.
inline bool make_map_tt(CUtensorMap* map, const View& v, int B, int S, int H,
                        int D, int rows, int cols = 64,
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  auto bytes = [](long long stride, int size) {
    return (cuuint64_t)(size == 1 ? 16 : stride * 2);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)S, (cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(v.ss, D), bytes(v.sh, H),
                                 bytes(v.sb, B)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return make_map_nd(map, v.p, 4, dims, strides, box, swizzle);
}

// A 4-D fp32 map: dims and element strides of dims 1..3 innermost first,
// boxes of 32 columns (128 bytes) by `rows`, 128-byte swizzle.  A dimension
// of size 1 is never stepped, so its stride is replaced by a valid one.
inline bool make_map_f32(CUtensorMap* map, const void* p,
                         const cuuint64_t (&dims)[4], const long long (&st)[3],
                         int rows) {
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)st[i] * 4;
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  return make_map_nd(map, p, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// Raises a kernel's dynamic shared-memory limit to `bytes`, once per device
// (`raised` is the caller's per-kernel bit set of devices).
template <typename K>
inline cudaError_t raise_smem(K kernel, int bytes, uint64_t& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (raised >> dev & 1)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) raised |= uint64_t(1) << dev;
  return err;
}

}  // namespace sm90
