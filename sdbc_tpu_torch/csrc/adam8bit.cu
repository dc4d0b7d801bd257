// Fused AdamW step over int8 moments for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/train/adam8bit.py
// _adam8_kernel (via _adam8_update): for one parameter leaf, dequantize the
// moments (m stored as sign*sqrt, v as a 4th root, each int8 with one fp32
// absmax per 2048-element row), update them, apply the bias-corrected AdamW
// step p -= lr*(m_hat/(sqrt(v_hat)+eps) + wd*p), and requantize with the
// row's new absmax (round half to even, clip to [-127, 127]).
//
// What bounds it on the H100: memory.  Per element it reads p, g (fp32) and
// the two int8 moments and writes p and the moments: 16 bytes for ~30 flops,
// far below the card's ~300 flops per byte.  The design moves each byte
// once: one block per 2048-element row reads and writes the leaf IN PLACE
// (the JAX wrapper's pad-to-rows copy would double the traffic; the ragged
// tail of the last row is masked instead), keeps the updated moments in
// registers (8 per thread), takes the row absmax with a warp-shuffle and
// shared-memory reduction in the same block, and only then requantizes: no
// second pass over the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 2048;            // quantization block (one row)
constexpr int THREADS = 256;
constexpr int PER = ROW / THREADS;   // elements per thread
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__global__ void __launch_bounds__(THREADS)
adam8_kernel(float* __restrict__ p, const float* __restrict__ g,
             int8_t* __restrict__ mq, float* __restrict__ ms,
             int8_t* __restrict__ vq, float* __restrict__ vs, long long n,
             float lr, float bc1, float bc2, float b1, float omb1, float b2,
             float omb2, float eps, float wd) {
  __shared__ float red_m[WARPS], red_v[WARPS];
  const long long base = (long long)blockIdx.x * ROW;
  const float msc = ms[blockIdx.x], vsc = vs[blockIdx.x];
  float m[PER], v[PER];
  float am = 0.f, av = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    m[j] = v[j] = 0.f;
    if (i < n) {
      const float gi = g[i], pi = p[i];
      const float mf = (float)mq[i] / 127.f;
      const float vf = (float)vq[i] / 127.f;
      float mi = sgn(mf) * mf * mf * msc;
      float vi = (vf * vf) * (vf * vf) * vsc;
      mi = b1 * mi + omb1 * gi;
      vi = b2 * vi + omb2 * gi * gi;
      const float mh = mi / bc1, vh = vi / bc2;
      const float upd = mh / (sqrtf(vh) + eps) + wd * pi;
      p[i] = pi - lr * upd;
      m[j] = mi;
      v[j] = vi;
      am = fmaxf(am, fabsf(mi));
      av = fmaxf(av, fabsf(vi));
    }
  }
  // row absmax: warp shuffle, then across the block's warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_m[warp] = am;
    red_v[warp] = av;
  }
  __syncthreads();
  am = red_m[0];
  av = red_v[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    am = fmaxf(am, red_m[w]);
    av = fmaxf(av, red_v[w]);
  }
  am = fmaxf(am, 1e-24f);
  av = fmaxf(av, 1e-24f);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    if (i < n) {
      const float nm = m[j] / am;
      const float nv = v[j] / av;
      const float qm = rintf(sgn(nm) * sqrtf(fabsf(nm)) * 127.f);
      const float qv = rintf(sqrtf(sqrtf(fmaxf(nv, 0.f))) * 127.f);
      mq[i] = (int8_t)fminf(fmaxf(qm, -127.f), 127.f);
      vq[i] = (int8_t)fminf(fmaxf(qv, -127.f), 127.f);
    }
  }
  if (threadIdx.x == 0) {  // every thread read ms/vs before the barrier
    ms[blockIdx.x] = am;
    vs[blockIdx.x] = av;
  }
}

}  // namespace

// p, g: fp32 leaf of n elements (contiguous, updated / read in place);
// mq, vq: int8 (rows, 2048); ms, vs: fp32 (rows,) with rows = ceil(n/2048).
// bc1/bc2 are the bias corrections 1 - b^step, omb1/omb2 = 1 - b1/b2 (all
// fp32, computed by the caller).  Returns cudaGetLastError() after the
// launch.
extern "C" int sdbc_adam8(void* p, const void* g, void* mq, void* ms, void* vq,
                          void* vs, long long n, float lr, float bc1,
                          float bc2, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (n + ROW - 1) / ROW;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  adam8_kernel<<<(unsigned)rows, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<int8_t*>(mq), static_cast<float*>(ms),
      static_cast<int8_t*>(vq), static_cast<float*>(vs), n, lr, bc1, bc2, b1,
      omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
