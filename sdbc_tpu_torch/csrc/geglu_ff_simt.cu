// The fused GEGLU feed-forward on the CUDA cores (FFMA, no tensor cores),
// for the rows the tensor-core kernel (geglu_ff_sm90.cu) does not take:
// fp32 rows (an fp32 pipeline) and widths that are not a multiple of 32
// (of 64 above 320).  bf16 or fp32, c <= 640, any row count.
//
// Replaces, for those rows, the JAX package's Pallas kernel sdbc_tpu/ops/
// geglu_ff.py _ff_kernel (via _geglu_ff_rows), which takes any dtype:
//   y + (val * gelu_erf(gate)).W2 + b2,  [val, gate] = LN(y).W1 + b1
// with the rounding points of geglu_ff_sm90.cu and of ops/geglu_ff.py
// geglu_ff_ref (every rounding to the dtype is exact in fp32): LayerNorm
// (eps given) with fp32 statistics rounded to the dtype, the up-projection
// accumulated in fp32 and rounded before + b1 (the sum rounded again), the
// GEGLU in fp32 rounded to the dtype, the down-projection in fp32 plus b2,
// the residual added in fp32 and rounded once.
//
// What bounds it on the H100: the FFMA rate (67 TFLOP/s in fp32): 24 c^2
// FLOPs a row against 4 c bytes in and out.  A simple kernel that is right:
// the bf16 sampling path at SD-1.5's widths does not reach it.
//
// Design: a block of 256 threads owns R = 8 rows.  A warp a row computes
// the LayerNorm into shared memory (fp32); then each thread takes val
// column n and gate column n + 4c of W1 for all 8 rows (W1 read once a
// block, coalesced; the normalized rows broadcast from shared memory) and
// writes the GEGLU's 4c-wide hidden rows to shared memory; then each thread
// takes one output column of W2 the same way.  The hidden stays on chip:
// R (c + 4c) floats, 100 KiB at c = 640.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;
constexpr int R = 8;  // rows a block, one warp each for the LayerNorm

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
geglu_ff_simt_kernel(const T* y, const float* gamma, const float* beta,
                     const T* w1, const T* b1, const T* w2, const T* b2,
                     T* out, int rows, int c, float eps) {
  extern __shared__ float sm[];
  float* xn = sm;         // R x c: LN(y) rounded to T
  float* hid = sm + R * c;  // R x 4c: val * gelu(gate) rounded to T
  const int r0 = blockIdx.x * R, c4 = 4 * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LayerNorm, a warp a row (rows past the end: zeros, never written)
  {
    const int row = r0 + warp;
    float* xr = xn + warp * c;
    if (row < rows) {
      const T* yr = y + (long long)row * c;
      float s = 0.f;
      for (int i = lane; i < c; i += 32) s += load(yr + i);
      const float mu = warp_sum(s) / c;
      float v = 0.f;
      for (int i = lane; i < c; i += 32) {
        const float d = load(yr + i) - mu;
        v += d * d;
      }
      const float rs = rsqrtf(warp_sum(v) / c + eps);
      for (int i = lane; i < c; i += 32)
        xr[i] = rnd<T>((load(yr + i) - mu) * rs * gamma[i] + beta[i]);
    } else {
      for (int i = lane; i < c; i += 32) xr[i] = 0.f;
    }
  }
  __syncthreads();

  // the up-projection and the GEGLU: val column n, gate column n + 4c
  for (int n = threadIdx.x; n < c4; n += NT) {
    float av[R], ag[R];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = ag[r] = 0.f;
    const T* wv = w1 + n;
    for (int k = 0; k < c; ++k) {
      const float a = load(wv + (long long)k * 2 * c4);
      const float g = load(wv + (long long)k * 2 * c4 + c4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = xn[r * c + k];
        av[r] = fmaf(x, a, av[r]);
        ag[r] = fmaf(x, g, ag[r]);
      }
    }
    const float bv = load(b1 + n), bg = load(b1 + c4 + n);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float val = rnd<T>(rnd<T>(av[r]) + bv);
      const float gate = rnd<T>(rnd<T>(ag[r]) + bg);
      hid[r * c4 + n] = rnd<T>(
          val * (0.5f * gate * (1.f + erff(gate * 0.7071067811865476f))));
    }
  }
  __syncthreads();

  // the down-projection, + b2, + the residual
  for (int m = threadIdx.x; m < c; m += NT) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < c4; ++k) {
      const float w = load(w2 + (long long)k * c + m);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(hid[r * c4 + k], w, acc[r]);
    }
    const float bo = load(b2 + m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r;
      if (row < rows) {
        const long long at = (long long)row * c + m;
        store(out + at, load(y + at) + (acc[r] + bo));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* y, const float* gamma, const float* beta,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int rows, int c, float eps,
                   cudaStream_t s) {
  const int smem = 4 * R * 5 * c;
  auto kern = geglu_ff_simt_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(rows + R - 1) / R, NT, smem, s>>>(
      static_cast<const T*>(y), gamma, beta, static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), rows, c, eps);
  return cudaGetLastError();
}

}  // namespace

// y and out (rows, c), w1 (c, 8c), b1 (8c), w2 (4c, c), b2 (c), all
// contiguous in one dtype (`dtype` 0 bf16, 1 fp32); gamma and beta (c)
// fp32; 0 < c <= 640.  Returns cudaGetLastError() after the launch.
extern "C" int sdbc_geglu_ff_simt(const void* y, const float* gamma,
                                  const float* beta, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int dtype,
                                  int rows, int c, float eps, void* stream) {
  if (rows <= 0 || c <= 0 || c > 640 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch<bf16>(y, gamma, beta, w1, b1, w2, b2, out, rows,
                                  c, eps, s)
                   : launch<float>(y, gamma, beta, w1, b1, w2, b2, out, rows,
                                   c, eps, s));
}
