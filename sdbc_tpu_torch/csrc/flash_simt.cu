// Flash attention on the CUDA cores (FFMA, no tensor cores), for the calls
// the tensor-core kernels do not take: fp32 q/k/v (an fp32 pipeline or
// train step) and head dims that are not a multiple of 8.  bf16 or fp32,
// head dims up to 512, any strides (in elements, the head dim's too).
//
// Replaces, for those calls, the JAX package's Pallas kernels, which take
// any dtype and pad any head dim: the fixed cap (sdbc_tpu/ops/
// flash_attention.py _fixed_kernel_bshd, _fixed_kernel_raw, _fixed_kernel),
// the training forward (_fwd_kernel) and the backward's two kernels
// (sdbc_tpu/ops/flash_attention_bwd.py _dq_kernel, _dkv_kernel).  The math
// and its rounding points are those of the tensor-core kernels and of the
// plain versions in ops/flash_attention.py and ops/flash_attention_bwd.py
// (for fp32 every rounding to the input dtype is exact):
//   forward  q prescaled by scale*log2e in fp32 and rounded to the input
//            dtype; s = q.k^T in fp32 (log2 units); the fixed cap
//            p = exp2(min(s, 60)), o = sum p.v / max(l, 1e-37); the
//            training forward a running row max m, p = exp2(s - m), each
//            tile rescaling l and o, and lse = m*ln2 + ln l; p rounded to
//            v's dtype before the P.V product, l summed from the fp32 p.
//   backward from ops/flash_attention_bwd.prepare's inputs (qs = scale*q,
//            kl = log2e*k, lse2, delta): p = exp2(qs.kl^T - lse2),
//            ds0 = p*(dO.V^T - delta) rounded to the dtype,
//            dq = dq_mul * sum ds0.kl, dk = sum ds0^T.qs,
//            dv = sum p^T.dO with p rounded to the dtype.
//
// What bounds it on the H100: the FFMA rate (67 TFLOP/s in fp32) and the
// shared-memory loads that feed it; the tensor-core kernels do the same
// work at 989 TFLOP/s in bf16.  A simple kernel that is right: nothing on
// the bf16 sampling and training paths at SD-1.5's shapes reaches it.
//
// Design: a block of 256 threads owns BR = 16 rows (queries; keys in the
// dk/dv kernel) of one (batch, head) and walks the other sequence in tiles
// of BT = 32, staged through shared memory as fp32.  Warp w computes the
// dot products of rows 2w and 2w+1, one partner row a lane (row strides in
// shared memory are odd, so the 32 lanes read 32 banks); the softmax
// statistics of a row are warp reductions; the same warp then accumulates
// those two rows' outputs, 16 threads a row, each holding DMAX/16 columns in
// registers.  Partner rows past the sequence are zero and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;  // threads a block
constexpr int BR = 16;   // the block's own rows
constexpr int BT = 32;   // partner rows a tile
constexpr int TPR = NT / BR;  // threads a row when accumulating
constexpr float CAP = 60.f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
// x rounded to T (exact for fp32)
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A (B, H, S, D) view: element (b, h, s, d) at p + b sb + h sh + s ss + d sd.
struct View {
  const void* p;
  long long sb, sh, ss, sd;
};

template <typename T>
__device__ __forceinline__ const T* base(const View& v, int b, int h) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh;
}

// Rows [r0, r0 + n) of a (batch, head)'s view into shared memory (row
// stride ldd), each value (with `scaled`) times `mul` rounded to T; rows at
// or past `rows` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ldd, const T* src,
                                      const View& v, int r0, int n, int rows,
                                      int D, float mul, bool scaled) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < rows) {
      x = load(src + (r0 + r) * v.ss + d * v.sd);
      if (scaled) x = rnd<T>(x * mul);
    }
    dst[r * ldd + d] = x;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

struct FwdParams {
  View q, k, v, o;
  float* lse;  // (B, H, Sq) fp32, the training forward only
  int H, Sq, Sk, D;
  float qscale;  // scale * log2e
};

// The forward: FIXED the fixed cap (no running max, no LSE), else the
// training forward.
template <typename T, bool FIXED, int DMAX>
__global__ void __launch_bounds__(NT) flash_simt_fwd_kernel(FwdParams p) {
  constexpr int NC = DMAX / TPR;  // output columns a thread
  extern __shared__ float sm[];
  const int D = p.D, ldr = D | 1;
  float* qs = sm;                 // BR x ldr
  float* ks = qs + BR * ldr;      // BT x ldr
  float* vs = ks + BT * ldr;      // BT x D
  float* ps = vs + BT * D;        // BR x (BT + 1)
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* Q = base<T>(p.q, b, h);
  const T* K = base<T>(p.k, b, h);
  const T* V = base<T>(p.v, b, h);
  stage<T>(qs, ldr, Q, p.q, q0, BR, p.Sq, D, p.qscale, true);

  const int r = threadIdx.x / TPR, c0 = threadIdx.x % TPR;  // output row
  float o[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) o[i] = 0.f;
  // the warp's two rows' statistics (every lane holds them)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* qa = qs + (2 * warp) * ldr;
  const float* qb = qa + ldr;

  for (int k0 = 0; k0 < p.Sk; k0 += BT) {
    __syncthreads();  // the previous tile is read (and Q staged)
    stage<T>(ks, ldr, K, p.k, k0, BT, p.Sk, D, 1.f, false);
    stage<T>(vs, D, V, p.v, k0, BT, p.Sk, D, 1.f, false);
    __syncthreads();
    const bool valid = k0 + lane < p.Sk;
    float s0 = dot(qa, ks + lane * ldr, D), s1 = dot(qb, ks + lane * ldr, D);
    float p0, p1, a0 = 1.f, a1 = 1.f;
    if (FIXED) {
      p0 = valid ? exp2f(fminf(s0, CAP)) : 0.f;
      p1 = valid ? exp2f(fminf(s1, CAP)) : 0.f;
      l0 += warp_sum(p0);
      l1 += warp_sum(p1);
    } else {
      s0 = valid ? s0 : -INFINITY;
      s1 = valid ? s1 : -INFINITY;
      const float n0 = fmaxf(m0, warp_max(s0)), n1 = fmaxf(m1, warp_max(s1));
      p0 = exp2f(s0 - n0);
      p1 = exp2f(s1 - n1);
      a0 = exp2f(m0 - n0);
      a1 = exp2f(m1 - n1);
      l0 = l0 * a0 + warp_sum(p0);
      l1 = l1 * a1 + warp_sum(p1);
      m0 = n0;
      m1 = n1;
    }
    ps[(2 * warp) * (BT + 1) + lane] = rnd<T>(p0);
    ps[(2 * warp + 1) * (BT + 1) + lane] = rnd<T>(p1);
    __syncwarp();
    // O of this thread's row (rows 2w, 2w+1 are this warp's): rescale, add
    // P.V over the tile
    const float a = lane < TPR ? a0 : a1;
    const float* pr = ps + r * (BT + 1);
    if (!FIXED) {
#pragma unroll
      for (int i = 0; i < NC; ++i) o[i] *= a;
    }
    for (int j = 0; j < BT; ++j) {
      const float pj = pr[j];
      const float* vr = vs + j * D;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = c0 + i * TPR;
        if (c < D) o[i] = fmaf(pj, vr[c], o[i]);
      }
    }
  }

  const int row = q0 + r;
  if (row >= p.Sq) return;
  const float l = lane < TPR ? l0 : l1;
  const float den = FIXED ? fmaxf(l, 1e-37f) : l;
  T* O = static_cast<T*>(const_cast<void*>(p.o.p)) + b * p.o.sb
         + h * p.o.sh + row * p.o.ss;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + i * TPR;
    if (c < D) st(O + c * p.o.sd, o[i] / den);
  }
  if (!FIXED && c0 == 0)
    p.lse[((long long)b * p.H + h) * p.Sq + row] =
        (lane < TPR ? m0 : m1) * LN2 + logf(l);
}

struct BwdParams {
  View qs, kl, v, dO, dq, dk, dv;
  const float* lse2;   // (B, H, Sq_pad) fp32
  const float* delta;  // (B, H, Sq_pad) fp32
  int H, Sq, Sk, D, Sqp;
  float dq_mul;  // scale / log2e
};

// dq for BR query rows, walking the keys.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_simt_dq_kernel(BwdParams p) {
  constexpr int NC = DMAX / TPR;
  extern __shared__ float sm[];
  const int D = p.D, ldr = D | 1;
  float* qs = sm;               // BR x ldr
  float* dos = qs + BR * ldr;   // BR x ldr
  float* ks = dos + BR * ldr;   // BT x ldr
  float* vs = ks + BT * ldr;    // BT x ldr
  float* dss = vs + BT * ldr;   // BR x (BT + 1)
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = (long long)b * p.H + h;
  stage<T>(qs, ldr, base<T>(p.qs, b, h), p.qs, q0, BR, p.Sq, D, 1.f, false);
  stage<T>(dos, ldr, base<T>(p.dO, b, h), p.dO, q0, BR, p.Sq, D, 1.f, false);
  const T* K = base<T>(p.kl, b, h);
  const T* V = base<T>(p.v, b, h);
  // the warp's two rows (zero past Sq: lse2 and delta are padded)
  const int ra = q0 + 2 * warp;
  const float* lse2 = p.lse2 + bh * p.Sqp + ra;
  const float* delta = p.delta + bh * p.Sqp + ra;
  const float lse_a = lse2[0], lse_b = lse2[1];
  const float del_a = delta[0], del_b = delta[1];
  const int r = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BT) {
    __syncthreads();
    stage<T>(ks, ldr, K, p.kl, k0, BT, p.Sk, D, 1.f, false);
    stage<T>(vs, ldr, V, p.v, k0, BT, p.Sk, D, 1.f, false);
    __syncthreads();
    const bool valid = k0 + lane < p.Sk;
    const float* kr = ks + lane * ldr;
    const float* vr = vs + lane * ldr;
    const float* qa = qs + (2 * warp) * ldr;
    const float* da = dos + (2 * warp) * ldr;
    const float pa = exp2f(dot(qa, kr, D) - lse_a);
    const float pb = exp2f(dot(qa + ldr, kr, D) - lse_b);
    const float dpa = dot(da, vr, D), dpb = dot(da + ldr, vr, D);
    float* ds = dss + (2 * warp) * (BT + 1) + lane;
    ds[0] = valid ? rnd<T>(pa * (dpa - del_a)) : 0.f;
    ds[BT + 1] = valid ? rnd<T>(pb * (dpb - del_b)) : 0.f;
    __syncwarp();
    const float* dr = dss + r * (BT + 1);
    for (int j = 0; j < BT; ++j) {
      const float dj = dr[j];
      const float* kj = ks + j * ldr;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = c0 + i * TPR;
        if (c < D) acc[i] = fmaf(dj, kj[c], acc[i]);
      }
    }
  }
  const int row = q0 + r;
  if (row >= p.Sq) return;
  T* out = static_cast<T*>(const_cast<void*>(p.dq.p)) + b * p.dq.sb
           + h * p.dq.sh + row * p.dq.ss;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + i * TPR;
    if (c < D) st(out + c * p.dq.sd, acc[i] * p.dq_mul);
  }
}

// dk and dv for BR key rows, walking the queries.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_simt_dkv_kernel(BwdParams p) {
  constexpr int NC = DMAX / TPR;
  extern __shared__ float sm[];
  const int D = p.D, ldr = D | 1;
  float* ks = sm;               // BR x ldr
  float* vs = ks + BR * ldr;    // BR x ldr
  float* qs = vs + BR * ldr;    // BT x ldr
  float* dos = qs + BT * ldr;   // BT x ldr
  float* pss = dos + BT * ldr;  // BR x (BT + 1): p rounded to the dtype
  float* dss = pss + BR * (BT + 1);
  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = (long long)b * p.H + h;
  stage<T>(ks, ldr, base<T>(p.kl, b, h), p.kl, k0, BR, p.Sk, D, 1.f, false);
  stage<T>(vs, ldr, base<T>(p.v, b, h), p.v, k0, BR, p.Sk, D, 1.f, false);
  const T* Q = base<T>(p.qs, b, h);
  const T* DO = base<T>(p.dO, b, h);
  const int r = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
  float ak[NC], av[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) ak[i] = av[i] = 0.f;

  for (int i0 = 0; i0 < p.Sq; i0 += BT) {
    __syncthreads();
    stage<T>(qs, ldr, Q, p.qs, i0, BT, p.Sq, D, 1.f, false);
    stage<T>(dos, ldr, DO, p.dO, i0, BT, p.Sq, D, 1.f, false);
    __syncthreads();
    // lane: query i0 + lane against this warp's keys 2w and 2w+1
    const int qi = i0 + lane;
    const bool valid = qi < p.Sq;
    const float lse = valid ? p.lse2[bh * p.Sqp + qi] : 0.f;
    const float del = valid ? p.delta[bh * p.Sqp + qi] : 0.f;
    const float* qr = qs + lane * ldr;
    const float* dr = dos + lane * ldr;
    const float* ka = ks + (2 * warp) * ldr;
    const float* va = vs + (2 * warp) * ldr;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pe = exp2f(dot(qr, ka + e * ldr, D) - lse);
      const float dpe = dot(dr, va + e * ldr, D);
      const int at = (2 * warp + e) * (BT + 1) + lane;
      pss[at] = valid ? rnd<T>(pe) : 0.f;
      dss[at] = valid ? rnd<T>(pe * (dpe - del)) : 0.f;
    }
    __syncwarp();
    const float* pr = pss + r * (BT + 1);
    const float* sr = dss + r * (BT + 1);
    for (int j = 0; j < BT; ++j) {
      const float pj = pr[j], sj = sr[j];
      const float* qj = qs + j * ldr;
      const float* dj = dos + j * ldr;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = c0 + i * TPR;
        if (c < D) {
          av[i] = fmaf(pj, dj[c], av[i]);
          ak[i] = fmaf(sj, qj[c], ak[i]);
        }
      }
    }
  }
  const int row = k0 + r;
  if (row >= p.Sk) return;
  T* dk = static_cast<T*>(const_cast<void*>(p.dk.p)) + b * p.dk.sb
          + h * p.dk.sh + row * p.dk.ss;
  T* dv = static_cast<T*>(const_cast<void*>(p.dv.p)) + b * p.dv.sb
          + h * p.dv.sh + row * p.dv.ss;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + i * TPR;
    if (c < D) {
      st(dk + c * p.dk.sd, ak[i]);
      st(dv + c * p.dv.sd, av[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

template <typename K>
cudaError_t raise_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, bool FIXED, int DMAX>
cudaError_t launch_fwd(const FwdParams& p, int B, cudaStream_t s) {
  const int ldr = p.D | 1;
  const int smem = 4 * ((BR + BT) * ldr + BT * p.D + BR * (BT + 1));
  auto kern = flash_simt_fwd_kernel<T, FIXED, DMAX>;
  cudaError_t err = raise_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((p.Sq + BR - 1) / BR, p.H, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t s) {
  const int ldr = p.D | 1;
  const int smem = 4 * ((2 * BR + 2 * BT) * ldr + BR * (BT + 1));
  auto kern = flash_simt_dq_kernel<T, DMAX>;
  cudaError_t err = raise_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((p.Sq + BR - 1) / BR, p.H, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t s) {
  const int ldr = p.D | 1;
  const int smem = 4 * ((2 * BR + 2 * BT) * ldr + 2 * BR * (BT + 1));
  auto kern = flash_simt_dkv_kernel<T, DMAX>;
  cudaError_t err = raise_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((p.Sk + BR - 1) / BR, p.H, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

// The instantiation for head dim D: DMAX the least of 64, 128, 256 and
// 512 that holds it.
template <typename T, bool FIXED>
cudaError_t fwd_by_d(const FwdParams& p, int B, cudaStream_t s) {
  if (p.D <= 64) return launch_fwd<T, FIXED, 64>(p, B, s);
  if (p.D <= 128) return launch_fwd<T, FIXED, 128>(p, B, s);
  if (p.D <= 256) return launch_fwd<T, FIXED, 256>(p, B, s);
  return launch_fwd<T, FIXED, 512>(p, B, s);
}

template <typename T>
cudaError_t bwd_by_d(const BwdParams& p, int B, bool dq, cudaStream_t s) {
  if (p.D <= 64)
    return dq ? launch_dq<T, 64>(p, B, s) : launch_dkv<T, 64>(p, B, s);
  if (p.D <= 128)
    return dq ? launch_dq<T, 128>(p, B, s) : launch_dkv<T, 128>(p, B, s);
  if (p.D <= 256)
    return dq ? launch_dq<T, 256>(p, B, s) : launch_dkv<T, 256>(p, B, s);
  return dq ? launch_dq<T, 512>(p, B, s) : launch_dkv<T, 512>(p, B, s);
}

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 512
         || B > 65535 || H > 65535;
}

View view(const void* p, const long long* st, int i) {
  return View{p, st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
}

}  // namespace

// The forward: q/k/v/o (B, H, S, D) views of one dtype (`dtype` 0 bf16,
// 1 fp32), `st` holding each one's (batch, head, seq, dim) strides in
// elements, in argument order; D <= 512.  fixed = 1: the fixed cap (`lse`
// unused); 0: the training forward, writing the natural-log LSE into the
// contiguous (B, H, Sq) fp32 `lse`.  Returns cudaGetLastError() after the
// launch.
extern "C" int sdbc_flash_simt_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype, int fixed, int B, int H,
                                   int Sq, int Sk, int D, const long long* st,
                                   float qscale, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D) || (dtype != 0 && dtype != 1)
      || (!fixed && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  const FwdParams p{view(q, st, 0), view(k, st, 1), view(v, st, 2),
                    view(o, st, 3), lse, H, Sq, Sk, D, qscale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(fixed ? fwd_by_d<bf16, true>(p, B, s)
                       : fwd_by_d<bf16, false>(p, B, s));
  return (int)(fixed ? fwd_by_d<float, true>(p, B, s)
                     : fwd_by_d<float, false>(p, B, s));
}

// The backward's two kernels on ops/flash_attention_bwd.prepare's inputs:
// qs, kl, v, dO and the outputs (B, H, S, D) views of one dtype (`dtype` 0
// bf16, 1 fp32), `st` holding each one's (batch, head, seq, dim) strides in
// elements in the order qs, kl, v, dO, dq (dq = 1) or qs, kl, v, dO, dk, dv
// (dq = 0); lse2 and delta contiguous (B, H, Sqp) fp32, Sqp >= Sq rounded
// up to 16, zero past Sq.  dq = 1 writes dq * dq_mul into `out0`; dq = 0
// writes dk into `out0` and dv into `out1`.  Returns cudaGetLastError()
// after the launch.
extern "C" int sdbc_flash_simt_bwd(const void* qs, const void* kl,
                                   const void* v, const void* dO,
                                   const float* lse2, const float* delta,
                                   void* out0, void* out1, int dtype, int dq,
                                   int B, int H, int Sq, int Sk, int D,
                                   int Sqp, const long long* st, float dq_mul,
                                   void* stream) {
  if (bad_shape(B, H, Sq, Sk, D) || (dtype != 0 && dtype != 1)
      || Sqp < (Sq + BR - 1) / BR * BR || (!dq && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const View none{nullptr, 0, 0, 0, 0};
  const BwdParams p{view(qs, st, 0), view(kl, st, 1), view(v, st, 2),
                    view(dO, st, 3), dq ? view(out0, st, 4) : none,
                    dq ? none : view(out0, st, 4),
                    dq ? none : view(out1, st, 5), lse2, delta, H, Sq, Sk, D,
                    Sqp, dq_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? bwd_by_d<bf16>(p, B, dq, s)
                          : bwd_by_d<float>(p, B, dq, s));
}
