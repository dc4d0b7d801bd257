// Fused GroupNorm(+SiLU) over NHWC activations for Hopper (sm_90a).
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
//
// Design (right and simple first).  The TPU kernel keeps one sample's slice
// resident in VMEM and reads x from HBM once.  On this card a 64^2 x 320
// bf16 slice (2.6 MB) does not fit one SM, and one block per sample would
// leave 124 of the 132 SMs idle at batch 8.  So three launches, all
// deterministic (no float atomics):
//   1. gn_stats:    grid (row chunk, 64-channel slab, sample); each thread
//                   owns one channel and 1/4 of the chunk's rows, the four
//                   partial sums meet in shared memory; per-chunk channel
//                   sums go to a (N, chunks, 2, C) fp32 scratch;
//   2. gn_finalize: one block per sample sums the chunks per channel, then
//                   each channel sums its group's channels in order and
//                   writes its a and b to a (N, 2, C) fp32 scratch;
//   3. gn_apply:    the stats grid again, y = x * a + b (+ SiLU).
// x is read twice; the second read mostly hits the 50 MB L2 at the UNet's
// sizes.  Later, one read and one write: JAX's 6 MiB fp32 cap is <= 3 MB of
// bf16, ~192 KB per block over a 16-block cluster (the non-portable cluster
// size), so a cluster can hold a sample's slice in shared memory and reduce
// its statistics over distributed shared memory before normalising.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 64;       // channels per block (one per thread)
constexpr int RL = 4;        // row lanes per block
constexpr int THREADS = CW * RL;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
         int chunk) {
  __shared__ float r1[RL][CW], r2[RL][CW];
  const int tx = threadIdx.x % CW, ty = threadIdx.x / CW;
  const int c = blockIdx.y * CW + tx, n = blockIdx.z;
  const int r_begin = blockIdx.x * chunk, r_end = min(HW, r_begin + chunk);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const T* xs = x + (long long)n * HW * C + c;
    for (int r = r_begin + ty; r < r_end; r += RL) {
      const float v = to_f(xs[(long long)r * C]);
      s1 += v;
      s2 += v * v;
    }
  }
  r1[ty][tx] = s1;
  r2[ty][tx] = s2;
  __syncthreads();
  if (ty < 2 && c < C) {
    float (*r)[CW] = ty == 0 ? r1 : r2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < RL; ++j) sum += r[j][tx];
    part[(((long long)n * gridDim.x + blockIdx.x) * 2 + ty) * C + c] = sum;
  }
}

// ab: (N, 2, C) fp32 — first the channel sums s1, s2, then a, b.  The
// sample's part of `part` is free once the chunks are summed, and holds a
// and b until every thread has read the sums.
__global__ void __launch_bounds__(256)
gn_finalize(float* __restrict__ part, const float* __restrict__ scale,
            const float* __restrict__ bias, float* __restrict__ ab, int C,
            int G, int chunks, float count, float eps) {
  const int n = blockIdx.x;
  float* s = ab + (long long)n * 2 * C;
  float* pn = part + (long long)n * chunks * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < chunks; ++k) {
      s1 += pn[(long long)k * 2 * C + c];
      s2 += pn[(long long)k * 2 * C + C + c];
    }
    s[c] = s1;
    s[C + c] = s2;
  }
  __syncthreads();
  const int cpg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int c0 = (c / cpg) * cpg;
    float g1 = 0.f, g2 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      g1 += s[c0 + i];
      g2 += s[C + c0 + i];
    }
    const float mean = g1 / count;
    const float var = fmaxf(g2 / count - mean * mean, 0.f);
    const float a = rsqrtf(var + eps) * scale[c];
    pn[c] = a;
    pn[C + c] = bias[c] - mean * a;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s[c] = pn[c];
    s[C + c] = pn[C + c];
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_apply(const T* __restrict__ x, const float* __restrict__ ab,
         T* __restrict__ y, int HW, int C, int chunk) {
  const int tx = threadIdx.x % CW, ty = threadIdx.x / CW;
  const int c = blockIdx.y * CW + tx, n = blockIdx.z;
  if (c >= C) return;
  const float a = ab[(long long)n * 2 * C + c];
  const float b = ab[(long long)n * 2 * C + C + c];
  const int r_begin = blockIdx.x * chunk, r_end = min(HW, r_begin + chunk);
  const long long base = (long long)n * HW * C + c;
  for (int r = r_begin + ty; r < r_end; r += RL) {
    float v = to_f(x[base + (long long)r * C]) * a + b;
    if (SILU) v = v * (1.f / (1.f + __expf(-v)));
    from_f(y[base + (long long)r * C], v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, float* part, float* ab, int N, int HW, int C,
                   int G, int chunk, float eps, int silu,
                   cudaStream_t stream) {
  const int chunks = (HW + chunk - 1) / chunk;
  const dim3 grid(chunks, (C + CW - 1) / CW, N);
  gn_stats<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), part,
                                             HW, C, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize<<<N, 256, 0, stream>>>(part, scale, bias, ab, C, G, chunks,
                                     (float)HW * (float)(C / G), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    gn_apply<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), ab, static_cast<T*>(y), HW, C, chunk);
  else
    gn_apply<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), ab, static_cast<T*>(y), HW, C, chunk);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (N, HW, C), bf16 (dtype 0) or fp32 (dtype 1); scale,
// bias: fp32 (C,); part: fp32 scratch of (N, ceil(HW / chunk), 2, C); ab:
// fp32 scratch of (N, 2, C).  C a multiple of G.  Returns
// cudaGetLastError() after the launches.
extern "C" int sdbc_group_norm(const void* x, const void* scale,
                               const void* bias, void* y, void* part,
                               void* ab, int N, int HW, int C, int G,
                               int chunk, float eps, int silu, int dtype,
                               void* stream) {
  if (N <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* p = static_cast<float*>(part);
  float* a = static_cast<float*>(ab);
  if (dtype == 0)
    return (int)launch<__nv_bfloat16>(x, sc, bi, y, p, a, N, HW, C, G, chunk,
                                      eps, silu, s);
  if (dtype == 1)
    return (int)launch<float>(x, sc, bi, y, p, a, N, HW, C, G, chunk, eps,
                              silu, s);
  return (int)cudaErrorInvalidValue;
}
