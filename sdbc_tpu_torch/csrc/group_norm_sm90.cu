// Fused GroupNorm(+SiLU) over NHWC activations for Hopper (sm_90a): one
// launch per call, one thread-block cluster per sample.
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/ops/pallas_groupnorm.py
// _gn_kernel (via _gn_fwd): per sample, fp32 channel sums s1 = sum x and
// s2 = sum x^2 over the rows, group sums of those, mean = s1 / count and
// var = max(s2 / count - mean^2, 0) with count = rows * C/G, inv =
// rsqrt(var + eps); per channel a = inv * scale and b = bias - mean * a;
// y = x * a + b, then SiLU (y * sigmoid(y)) if asked, cast to x's type.
//
// What bounds it on the H100: memory.  Per element it reads x and writes y
// (2 + 2 bytes in bf16) for ~6 fp32 operations.  At the UNet's largest
// eligible tensor, (8, 64^2, 320) bf16, that is 42 MB: 12.5 us at 3.35 TB/s.
// The TPU kernel keeps a sample's slice in VMEM between the statistics and
// the normalisation, so HBM sees one read and one write of x; here a
// cluster's shared memory plays that part.
//
// Design:
// - grid (cs, N), cluster (cs, 1, 1), cs <= 16 (the non-portable size): the
//   cluster's CTAs split the sample's rows evenly, CTA r taking rows
//   [r * HW / cs, (r + 1) * HW / cs).
// - Each CTA brings the first `res` rows of its slab into shared memory
//   with one 1-D bulk copy (cp.async.bulk: a sample's NHWC rows are
//   contiguous bytes, no tensor map) completing on an mbarrier.  (Split
//   into 2, 4 or 8 copies on their own mbarriers, to start the statistics
//   on the first rows, it was slower on the H100 at every UNet shape.)
//   Rows past `res` (a slab larger than shared memory: fp32 near the cap,
//   or a cluster packed two CTAs to an SM) are read from global memory in
//   both passes, four loads in flight: only they are read twice.
// - Statistics: thread (lane, col) sums W channels (one 16-byte vector) of
//   rows lane, lane + lanes, ...; the lanes meet in shared memory and the
//   channels in their groups, in a fixed order.  Each CTA stores its G
//   group partials (s1, s2) into slot `rank` of every peer's receive
//   buffer over distributed shared memory (mapa + st.shared::cluster), one
//   barrier.cluster, then every CTA sums the cs slots in rank order: all
//   of them hold the same bits, and two calls give the same bits.  No
//   atomics, no scratch in device memory.  (Group partials rather than
//   channel partials: at C = 2560 over 16 CTAs the channel partials would
//   take 320 KB of receive buffer a CTA; the group partials take 4 KB.)
// - Apply: a and b of the thread's W channels from the group statistics,
//   scale and bias read in their own dtype (bf16 or fp32: no cast launch
//   on the host); y = x * a + b (+ SiLU) from the shared-memory copy,
//   16-byte stores.  SiLU's reciprocal alternates between the
//   special-function unit and Newton's method on the FMA pipe, so that the
//   unit (16 results a clock an SM) does not set the apply pass's pace.
// - A C whose rows are not whole 16-byte vectors (or a misaligned base)
//   takes the same template with W = 1: element accesses, the slab filled
//   by the threads' own loads instead of bulk copies.  Groups may straddle
//   a vector (C/G = 3 at C = 96): channels meet their group one by one.
// The host (ops/pallas_groupnorm.py::plan) picks cs, the thread layout and
// `res` from cudaOccupancyMaxActiveClusters (sdbc_group_norm_max_clusters)
// so that a batch's clusters run in one wave where they can.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int HEAD_BYTES = 128;   // the mbarrier

// Byte offset of the slab in dynamic shared memory (as plan computes it):
// the mbarrier, then fp32 group sums [2][G], the receive buffer
// [cs][2][G] and the lane partials [2][lanes][cv * W], rounded up to 128.
__host__ __device__ inline int slab_offset(int G, int cs, int lanes, int cv,
                                           int W) {
  const long long floats =
      2LL * G + 2LL * cs * G + 2LL * lanes * cv * W;
  const long long b = HEAD_BYTES + 4 * floats;
  return (int)((b + 127) / 128 * 128);
}

struct Params {
  const void* x;
  void* y;
  const void* scale;
  const void* bias;
  int hw, c, g;  // rows, channels, groups
  int cs;        // CTAs per sample (the cluster)
  int lanes;     // row lanes per column chunk
  int cv;        // vectors per column chunk
  int res;       // rows of a CTA's slab held in shared memory (at most)
  int sdtype, bdtype;  // scale / bias: 0 bf16, 1 fp32
  float count, eps;
};

template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16(x);
}

__device__ __forceinline__ float param(const void* p, int dtype, int c) {
  return dtype ? static_cast<const float*>(p)[c]
               : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]);
}

template <typename T, int W>
__device__ __forceinline__ void accumulate(const Vec<T, W>& v, float* s1,
                                           float* s2) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float f = to_f(v.v[j]);
    s1[j] += f;
    s2[j] = fmaf(f, f, s2[j]);
  }
}

// 1 / d for d in [1, 2^64] without the special-function unit: a first
// guess from the bits (within 5.1%), then STEPS Newton steps, each
// squaring the relative error (2 steps: 6.7e-6, 3: 1.5e-7).
template <int STEPS>
__device__ __forceinline__ float rcp_newton(float d) {
  float r = __int_as_float(0x7EF311C3 - __float_as_int(d));
#pragma unroll
  for (int i = 0; i < STEPS; ++i) r *= fmaf(-d, r, 2.f);
  return r;
}

// t * sigmoid(t) = t / (1 + 2^(-t log2 e)), subnormals flushed.  The
// exponential is ex2 on the special-function unit (16 results a clock an
// SM, against 128 fused multiply-adds); the reciprocal is rcp there too
// (FMA_RCP false) or Newton's (true: 2 steps for a bf16 output, 3 for
// fp32), the exponent clamped at 64 so that its guess stays a normal float.
// The caller takes the two in turn: with both on the special-function unit
// the apply pass waits on it (two of its results an element).
template <typename T, bool FMA_RCP>
__device__ __forceinline__ float silu(float t) {
  float e, r;
  const float arg = t * -1.4426950408889634f;
  if (FMA_RCP) {
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(fminf(arg, 64.f)));
    r = rcp_newton<sizeof(T) == 2 ? 2 : 3>(1.f + e);
  } else {
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(arg));
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  }
  return t * r;
}

template <typename T, int W, bool SILU>
__device__ __forceinline__ Vec<T, W> normalise(const Vec<T, W>& v,
                                               const float* a,
                                               const float* b) {
  Vec<T, W> o;
  if constexpr (sizeof(T) == 2 && W % 2 == 0) {  // bf16: two to a convert
#pragma unroll
    for (int j = 0; j < W; j += 2) {
      float t0 = fmaf(to_f(v.v[j]), a[j], b[j]);
      float t1 = fmaf(to_f(v.v[j + 1]), a[j + 1], b[j + 1]);
      if (SILU) {
        t0 = silu<T, false>(t0);
        t1 = silu<T, true>(t1);
      }
      *reinterpret_cast<__nv_bfloat162*>(&o.v[j]) =
          __floats2bfloat162_rn(t0, t1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float t = fmaf(to_f(v.v[j]), a[j], b[j]);
      if (SILU) t = j % 2 ? silu<T, true>(t) : silu<T, false>(t);
      from_f(o.v[j], t);
    }
  }
  return o;
}

// Calls f(v, off) for the rows r, r + step, ... below `end` of column `col`
// (W channels) of `src`, off the row's offset in elements: UNROLL loads in
// flight, every load of a round issued before the first is used, so a
// round waits out one latency of global memory, not UNROLL of them; full
// rounds, then one round of what is left.
constexpr int UNROLL = 4;

template <typename T, int W, typename F>
__device__ __forceinline__ void for_rows(const T* __restrict__ src, int C,
                                         int col, int r, int end, int step,
                                         F f) {
  using V = Vec<T, W>;
  if (r >= end) return;
  const long long stride = (long long)step * C;
  long long off = (long long)r * C + col * W;
  int left = (end - r - 1) / step + 1;
  for (; left >= UNROLL; left -= UNROLL, off += UNROLL * stride) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = *reinterpret_cast<const V*>(src + off + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) f(v[u], off + u * stride);
  }
  if (left > 0) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < left) v[u] = *reinterpret_cast<const V*>(src + off + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < left) f(v[u], off + u * stride);
  }
}

// Adds the rows to s1, s2.
template <typename T, int W>
__device__ __forceinline__ void sum_rows(const T* src, int C, int col, int r,
                                         int end, int step, float* s1,
                                         float* s2) {
  for_rows<T, W>(src, C, col, r, end, step,
                 [&](const Vec<T, W>& v, long long) {
                   accumulate<T, W>(v, s1, s2);
                 });
}

// The element path's fill: the rows from global memory into the slab,
// added to s1, s2 on the way.
template <typename T, int W>
__device__ __forceinline__ void copy_rows(const T* x, T* __restrict__ slab,
                                          int C, int col, int r, int end,
                                          int step, float* s1, float* s2) {
  for_rows<T, W>(x, C, col, r, end, step,
                 [&](const Vec<T, W>& v, long long off) {
                   *reinterpret_cast<Vec<T, W>*>(slab + off) = v;
                   accumulate<T, W>(v, s1, s2);
                 });
}

// y = normalise(src) over the rows.
template <typename T, int W, bool SILU>
__device__ __forceinline__ void apply_rows(const T* src, T* __restrict__ y,
                                           int C, int col, int r, int end,
                                           int step, const float* a,
                                           const float* b) {
  for_rows<T, W>(src, C, col, r, end, step,
                 [&](const Vec<T, W>& v, long long off) {
                   *reinterpret_cast<Vec<T, W>*>(y + off) =
                       normalise<T, W, SILU>(v, a, b);
                 });
}

template <typename T, int W, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS, 1)
gn_cluster_kernel(Params p) {
  constexpr bool BULK = W * sizeof(T) == 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* grp = reinterpret_cast<float*>(smem + HEAD_BYTES);  // [2][G]
  float* recv = grp + 2 * p.g;                               // [cs][2][G]
  float* red = recv + 2 * p.cs * p.g;  // [2][lanes][cv * W]
  T* slab = reinterpret_cast<T*>(
      smem + slab_offset(p.g, p.cs, p.lanes, p.cv, W));

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rank = (int)sm90::cluster_ctarank();
  const int C = p.c, G = p.g, nv = C / W, cpg = C / G;
  const int r0 = (int)((long long)rank * p.hw / p.cs);
  const int rows = (int)((long long)(rank + 1) * p.hw / p.cs) - r0;
  const int res = min(rows, p.res);
  const long long base = ((long long)blockIdx.y * p.hw + r0) * C;
  const T* x = static_cast<const T*>(p.x) + base;
  T* y = static_cast<T*>(p.y) + base;
  // a thread owns at most one (lane, column) item of a column chunk of cv
  // vectors (threads >= lanes * cv)
  const int items = p.lanes * p.cv, rstride = p.cv * W;
  const int lane = tid / p.cv;

  if (BULK && tid == 0 && res > 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  for (int i = tid; i < 2 * G; i += nthr) grp[i] = 0.f;
  __syncthreads();
  if (BULK && tid == 0 && res > 0) {
    const uint32_t bytes = (uint32_t)((long long)res * C * sizeof(T));
    sm90::mbar_expect_tx(bar, bytes);
    sm90::bulk_load(slab, x, bytes, bar);
  }
  // Peers write into this CTA's shared memory only once it has started.
  sm90::cluster_arrive_relaxed();
  // the scale and bias of this thread's first column, loaded while x comes
  float sc[W], bi[W];
  if (tid < items) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int ch = (tid % p.cv) * W + j;
      sc[j] = param(p.scale, p.sdtype, ch);
      bi[j] = param(p.bias, p.bdtype, ch);
    }
  }

  // ---- statistics
  for (int cb = 0; cb < nv; cb += p.cv) {
    const int width = (min(nv, cb + p.cv) - cb) * W, c_lo = cb * W;
    const int col = cb + tid % p.cv;
    const bool mine = tid < items && col < nv;
    float s1[W], s2[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s1[j] = s2[j] = 0.f;
    if (mine) {
      // rows past the resident part, from global memory (first: their
      // loads overlap the bulk copy in flight), then the resident rows
      sum_rows<T, W>(x, C, col, res + lane, rows, p.lanes, s1, s2);
      if (BULK) {
        if (cb == 0 && res > 0) sm90::mbar_wait(bar, 0);
        sum_rows<T, W>(slab, C, col, lane, res, p.lanes, s1, s2);
      } else {
        copy_rows<T, W>(x, slab, C, col, lane, res, p.lanes, s1, s2);
      }
      float* r1 = red + lane * rstride + (col - cb) * W;
      float* r2 = r1 + p.lanes * rstride;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        r1[k] = s1[k];
        r2[k] = s2[k];
      }
    }
    __syncthreads();
    // this chunk's partials into their groups, in a fixed order: a team
    // of P threads (a power of two within a warp, as many as the block
    // gives every (group, statistic)) per group, thread k of a team over
    // lanes k, k + P, ... (channel j into running sum j % 4), then a
    // butterfly over the team; a group that straddles chunks adds up in
    // chunk order
    const int g_lo = c_lo / cpg, ng = (c_lo + width - 1) / cpg - g_lo + 1;
    const int tasks = 2 * ng;
    int P = 1;
    while (P < 32 && 2 * P * tasks <= nthr) P *= 2;
    for (int i0 = 0; i0 < tasks * P; i0 += nthr) {
      const int task = (i0 + tid) / P, k = (i0 + tid) % P;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      int st = 0, g = 0;
      if (task < tasks) {
        st = task / ng;
        g = g_lo + task % ng;
        const int a = max(g * cpg, c_lo) - c_lo;
        const int span = min((g + 1) * cpg, c_lo + width) - c_lo - a;
        const float* part = red + (st * p.lanes + k) * rstride + a;
        for (int l = k; l < p.lanes; l += P, part += P * rstride) {
          int j = 0;
          for (; j + 4 <= span; j += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u) s4[u] += part[j + u];
          }
          if (j < span) s4[0] += part[j];
          if (j + 1 < span) s4[1] += part[j + 1];
          if (j + 2 < span) s4[2] += part[j + 2];
        }
      }
      float acc = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      for (int o = P / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (task < tasks && k == 0) grp[st * G + g] += acc;
    }
    __syncthreads();
  }

  // ---- the cluster's sums: every CTA's partials into slot `rank` of
  // every peer (16 bytes a store where G is even), one cluster barrier,
  // the slots summed in rank order
  sm90::cluster_wait();
  if (G % 2 == 0) {
    const int q4 = G / 2;  // float4s of a slot
    for (int i = tid; i < p.cs * q4; i += nthr) {
      const int peer = i / q4, k = 4 * (i % q4);
      sm90::st_peer_v4(sm90::peer_addr(recv + rank * 2 * G + k, peer),
                       grp[k], grp[k + 1], grp[k + 2], grp[k + 3]);
    }
  } else {
    for (int i = tid; i < p.cs * 2 * G; i += nthr) {
      const int peer = i / (2 * G), k = i % (2 * G);
      sm90::st_peer_f32(sm90::peer_addr(recv + rank * 2 * G + k, peer),
                        grp[k]);
    }
  }
  sm90::cluster_sync();
  for (int g = tid; g < G; g += nthr) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < p.cs; ++q) {
      s1 += recv[q * 2 * G + g];
      s2 += recv[q * 2 * G + G + g];
    }
    const float mean = s1 / p.count;
    const float var = fmaxf(s2 / p.count - mean * mean, 0.f);
    grp[g] = mean;
    grp[G + g] = rsqrtf(var + p.eps);
  }
  __syncthreads();

  // ---- apply, from the shared-memory copy (the rows past `res` again
  // from global memory)
  for (int cb = 0; cb < nv; cb += p.cv) {
    const int col = cb + tid % p.cv;
    if (tid < items && col < nv) {
      float a[W], b[W];
      int g = col * W / cpg, rem = col * W - g * cpg;  // channel col * W
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int ch = col * W + j;
        a[j] = grp[G + g] * (cb ? param(p.scale, p.sdtype, ch) : sc[j]);
        b[j] = (cb ? param(p.bias, p.bdtype, ch) : bi[j]) - grp[g] * a[j];
        if (++rem == cpg) {
          rem = 0;
          ++g;
        }
      }
      apply_rows<T, W, SILU>(slab, y, C, col, lane, res, p.lanes, a, b);
      apply_rows<T, W, SILU>(x, y, C, col, res + lane, rows, p.lanes, a, b);
    }
  }
}

using Kernel = void (*)(Params);

template <typename T, int W, bool SILU>
Kernel kernel_of() {
  return gn_cluster_kernel<T, W, SILU>;
}

// The instantiation for (x dtype, vector path, SiLU).
Kernel select(int dtype, int vec, int silu) {
  if (dtype == 0) {
    if (vec) return silu ? kernel_of<__nv_bfloat16, 8, true>()
                         : kernel_of<__nv_bfloat16, 8, false>();
    return silu ? kernel_of<__nv_bfloat16, 1, true>()
                : kernel_of<__nv_bfloat16, 1, false>();
  }
  if (vec) return silu ? kernel_of<float, 4, true>()
                       : kernel_of<float, 4, false>();
  return silu ? kernel_of<float, 1, true>() : kernel_of<float, 1, false>();
}

// Once per instantiation and device: the full shared memory and clusters
// of up to 16 CTAs.
cudaError_t prepare(Kernel k, int index) {
  static unsigned done[8] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done[index] >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  if (dev < 32) done[index] |= 1u << dev;
  return cudaSuccess;
}

cudaLaunchConfig_t config(int cs, int n, int threads, int smem,
                          cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// One call's layout, as ops/_kernels.py::GroupNormLaunch packs it (built
// once per shape and cached on the host, so a call passes six pointers).
// x, y: contiguous (n, hw, c), bf16 (dtype 0) or fp32 (dtype 1); scale,
// bias: (c,) in sdtype / bdtype (0 bf16, 1 fp32).  The plan
// (ops/pallas_groupnorm.py::plan): cs CTAs per sample, `threads` a block,
// lanes x cv items per column chunk, `res` resident rows, vec 1 for 16-byte
// accesses (bulk copies).
struct GnLaunch {
  int n, hw, c, g, cs, threads, lanes, cv, res, vec, silu, dtype, sdtype,
      bdtype;
  float eps;
};

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a layout the kernel does not take.
extern "C" int sdbc_group_norm(const void* x, const void* scale,
                               const void* bias, void* y, const GnLaunch* l,
                               void* stream) {
  const int N = l->n, HW = l->hw, C = l->c, G = l->g, cs = l->cs;
  const int dtype = l->dtype, vec = l->vec, silu = l->silu;
  const int esize = dtype == 0 ? 2 : 4, W = vec ? 16 / esize : 1;
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
      cs < 1 || cs > MAX_CLUSTER || l->threads < 32 ||
      l->threads > MAX_THREADS || l->threads % 32 || l->lanes < 1 ||
      l->cv < 1 || l->lanes * l->cv > l->threads || l->res < 0 ||
      (dtype != 0 && dtype != 1) ||
      (l->sdtype != 0 && l->sdtype != 1) ||
      (l->bdtype != 0 && l->bdtype != 1) || C % W != 0)
    return (int)cudaErrorInvalidValue;
  if (vec && ((long long)C * esize % 16 != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      slab_offset(G, cs, l->lanes, l->cv, W) + (long long)l->res * C * esize;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int index = dtype * 4 + (vec ? 2 : 0) + (silu ? 1 : 0);
  const Kernel k = select(dtype, vec, silu);
  cudaError_t err = prepare(k, index);
  if (err != cudaSuccess) return (int)err;
  Params p{x,         y,         scale,  bias,  HW,
           C,         G,         cs,     l->lanes, l->cv,
           l->res,    l->sdtype, l->bdtype, (float)HW * (float)(C / G),
           l->eps};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(cs, N, l->threads, (int)smem,
             static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, k, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cs` CTAs (of `threads` threads and `smem` bytes of
// dynamic shared memory) the card holds at once, for the instantiation of
// (dtype, vec, silu): cudaOccupancyMaxActiveClusters into *out.
extern "C" int sdbc_group_norm_max_clusters(int dtype, int vec, int silu,
                                            int cs, int threads, int smem,
                                            int* out) {
  if (cs < 1 || cs > MAX_CLUSTER || threads < 1 || threads > MAX_THREADS ||
      smem < 0 || smem > SMEM_MAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int index = dtype * 4 + (vec ? 2 : 0) + (silu ? 1 : 0);
  const Kernel k = select(dtype, vec, silu);
  cudaError_t err = prepare(k, index);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cs, 1, threads, smem, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(k), &cfg);
}
