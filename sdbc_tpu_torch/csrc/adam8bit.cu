// Fused AdamW step over int8 moments for Hopper (sm_90a): one launch for
// every 8-bit leaf of an optimizer step.
//
// Replaces the JAX package's Pallas kernel sdbc_tpu/train/adam8bit.py
// _adam8_kernel (via _adam8_update, one pallas_call per leaf): for each
// parameter leaf, dequantize the moments (m stored as sign*sqrt, v as a 4th
// root, each int8 with one fp32 absmax per 2048-element row), update them,
// apply the bias-corrected AdamW step p -= lr*(m_hat/(sqrt(v_hat)+eps) +
// wd*p), and requantize with the row's new absmax (round half to even,
// clip to [-127, 127]).
//
// What bounds it on the H100: memory.  Per element it reads p, g (fp32) and
// the two int8 moments and writes p and the moments: 16 bytes, against a
// few tens of issued instructions.  A step of SD-1.5's mode C moves 15.7 GB
// (0.98 G elements in 289 leaves): 4.7 ms at 3.35 TB/s.
//
// Design:
// - One launch walks the step's global row space: the rows of all leaves,
//   leaf after leaf.  A table in device memory (built by the caller, one
//   copy per step) holds per leaf its first global row, its length n, its
//   part length and first part, and the moment pointers; per part the
//   pointers of p and g.  A part is one tensor: a leaf is one tensor, or
//   the same-shape tensors the JAX package stacks into one array (the
//   text encoder's layers).  Element i of a leaf lives in part i / part_n
//   at i % part_n, so stacked leaves are read and written in place.
// - One 128-thread block updates one row: 16 consecutive elements a
//   thread, so every access is a 16-byte vector (16 int8 moments, 4 fp32),
//   and the ten loads of a thread are in flight at once.  A block finds its
//   row's leaf by binary search over the leaves' first rows (the table
//   stays in the L1 and L2 caches).  A block a row lets the card's block
//   scheduler keep every SM's row slots full; persistent grids of 8 to 64
//   blocks an SM, each walking a contiguous run of rows, measured slower.
// - The updated m and v stay in registers until the row's absmax is known
//   (warp shuffles, then four partials in shared memory): every byte is
//   read once and written once.
// - Arithmetic: the moments are computed exactly as the plain version
//   computes them on the card (PyTorch's CUDA kernels: a division by a
//   Python number is a multiplication by its fp32 reciprocal, every other
//   operation rounded on its own, no FMA contraction), so the int8 codes
//   and the row scales come out the same: a code one off would move that
//   element's later steps by a fraction of lr.  The division by the row's
//   absmax is one multiplication by its correctly rounded reciprocal
//   (taken once per row) and one FMA correction of the remainder (the
//   correctly rounded quotient wherever it was held to a true division);
//   the codes' square roots are the
//   special-function unit's (a few ulp off), and only where 127*sqrt lands
//   within 1e-3 of a rounding tie does the IEEE root decide.  The
//   parameter step itself takes the unit's square root and reciprocal
//   (sqrt.approx, rcp.approx): a few ulp of one step, far inside the
//   tolerance.
// - A thread whose 16 elements cross a part boundary or the end of the
//   leaf takes an element-by-element path; with every part length a
//   multiple of 16 (all of SD-1.5's) only the ragged last row of a leaf
//   does.  That path's loads and stores and the IEEE roots are out of line
//   (CALLed): the kernel's body is the 16-byte path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 2048;           // quantization block (one row)
constexpr int THREADS = 128;
constexpr int VEC = ROW / THREADS;  // 16 elements a thread
constexpr int WARPS = THREADS / 32;

// The caller's table, int64 words: `nleaves` leaves, then the parts.
struct Leaf {
  long long row0;    // first row in the step's global row space
  long long n;       // elements (< 2^31)
  long long part_n;  // elements per part (n = part_n * parts)
  long long part0;   // index of the leaf's first part
  int8_t* mq;        // (rows, 2048)
  float* ms;         // (rows,)
  int8_t* vq;
  float* vs;
};

struct Part {
  float* p;
  const float* g;
};

struct Hyper {
  float lr, rbc1, rsbc2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Signed byte k of the 16-byte vector w.
__device__ __forceinline__ int byte_at(const uint4& w, int k) {
  const uint32_t word = k < 4 ? w.x : k < 8 ? w.y : k < 12 ? w.z : w.w;
  return (int)(int8_t)(word >> (8 * (k % 4)));
}

// One element's moment update and parameter step, from its int8 codes and
// its row's scales: m = sign(c)c^2 ms, v = c^4 vs with c = code / 127 (the
// division as a multiplication by 1/127, the plain version's on the card),
// then the moment updates, each operation rounded on its own.
__device__ __forceinline__ void step1(float& p, float g, int qm, int qv,
                                      float msc, float vsc, const Hyper& h,
                                      float& m, float& v) {
  constexpr float R127 = 1.f / 127.f;
  const float cm = __fmul_rn((float)qm, R127), cv = __fmul_rn((float)qv, R127);
  const float c2 = __fmul_rn(cv, cv);
  const float md = __fmul_rn(__fmul_rn(fabsf(cm), cm), msc);
  const float vd = __fmul_rn(__fmul_rn(c2, c2), vsc);
  m = __fadd_rn(__fmul_rn(h.b1, md), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, vd), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = fmaf(sqrt_approx(v), h.rsbc2, h.eps);
  p -= h.lr * fmaf(m * h.rbc1, rcp_approx(den), h.wd * p);
}

// x / a, correctly rounded, from ra = RN(1/a): the product and one FMA
// correction of its remainder.
__device__ __forceinline__ float div_rn(float x, float a, float ra) {
  const float y = __fmul_rn(x, ra);
  return fmaf(fmaf(-y, a, x), ra, y);
}

// rint(127 sqrt(x)) (root4: of sqrt(x)) with IEEE square roots: out of
// line, taken only near a rounding tie.
__device__ __noinline__ int code_ieee(float x, bool root4) {
  return __float2int_rn(
      __fmul_rn(root4 ? __fsqrt_rn(__fsqrt_rn(x)) : __fsqrt_rn(x), 127.f));
}

// rint(127 sqrt(x)) (root4: of sqrt(x), the 4th root) for x in [0, 1],
// as with IEEE square roots.
__device__ __forceinline__ int code(float x, bool root4) {
  const float y =
      127.f * (root4 ? sqrt_approx(sqrt_approx(x)) : sqrt_approx(x));
  const float r = rintf(y);
  const int q = fabsf(y - r) > 0.499f ? code_ieee(x, root4) : (int)r;
  return min(127, q);
}

// The int8 codes of four m (sign * sqrt) or v (4th root) normalised by the
// row's absmax a (ra = RN(1/a)), packed four to a word.
__device__ __forceinline__ uint32_t quant4(const float* x, float a, float ra,
                                           bool root4) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float nx = div_rn(x[k], a, ra);
    int q = code(root4 ? fmaxf(nx, 0.f) : fabsf(nx), root4);
    if (!root4 && nx < 0.f) q = -q;
    out |= (uint32_t)(q & 0xff) << (8 * k);
  }
  return out;
}

struct Vec16 {
  float x[VEC];
};
struct Vec32 {
  float p[VEC], g[VEC];
};

// The thread's p and g one element at a time (0 past n), out of line: the
// ragged end of a leaf, or 16 elements across a part boundary.
__device__ __noinline__ Vec32 load_elementwise(const Part* parts,
                                               long long part0, int i0, int n,
                                               int part_n) {
  Vec32 out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int i = i0 + e, q = i / part_n;
    out.p[e] = i < n ? parts[part0 + q].p[i - q * part_n] : 0.f;
    out.g[e] = i < n ? parts[part0 + q].g[i - q * part_n] : 0.f;
  }
  return out;
}

__device__ __noinline__ void store_elementwise(const Part* parts,
                                               long long part0, int i0, int n,
                                               int part_n, Vec16 p) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int i = i0 + e, q = i / part_n;
    if (i < n) parts[part0 + q].p[i - q * part_n] = p.x[e];
  }
}

// The register budget of 6 blocks an SM (80 registers): measured faster
// than the compiler's own 72-register schedule (7 blocks) and than budgets
// for 8 to 10 blocks; fewer blocks (a shared-memory pad) were slower.
__global__ void __launch_bounds__(THREADS, 6)
adam8_leaves_kernel(const Leaf* __restrict__ leaves, int nleaves,
                    const Part* __restrict__ parts, Hyper h) {
  __shared__ float red[2][WARPS];  // [m, v][warp]
  const long long r = blockIdx.x;  // this block's row
  int li = 0;  // its leaf: the last one with row0 <= r
  for (int hi = nleaves - 1; li < hi;) {
    const int mid = (li + hi + 1) / 2;
    if (leaves[mid].row0 <= r) li = mid; else hi = mid - 1;
  }
  const Leaf L = leaves[li];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const long long lrow = r - L.row0;
  const int n = (int)L.n, part_n = (int)L.part_n;
  const int i0 = (int)lrow * ROW + t * VEC;  // first element, in the leaf
  const float msc = L.ms[lrow], vsc = L.vs[lrow];
  const uint4 qm = *reinterpret_cast<const uint4*>(L.mq + lrow * ROW + t * VEC);
  const uint4 qv = *reinterpret_cast<const uint4*>(L.vq + lrow * ROW + t * VEC);
  const int pi = i0 < part_n ? 0 : i0 / part_n;
  const int off = i0 - pi * part_n;
  const bool fast = i0 + VEC <= n && off + VEC <= part_n && (off & 3) == 0;

  // p and g: four 16-byte vectors each, or (rarely) element by element
  // (elements past n read as 0 and keep m = v = 0: no effect on the
  // absmax, and they requantize to 0, as the plain version's zero pad)
  float pv[VEC], gv[VEC], m[VEC], v[VEC];
  const Part P = parts[L.part0 + (fast ? pi : 0)];
  if (fast) {
    const float4* pp = reinterpret_cast<const float4*>(P.p + off);
    const float4* gp = reinterpret_cast<const float4*>(P.g + off);
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      const float4 a = pp[c], b = __ldcs(gp + c);  // g: read once
      pv[4 * c] = a.x; pv[4 * c + 1] = a.y;
      pv[4 * c + 2] = a.z; pv[4 * c + 3] = a.w;
      gv[4 * c] = b.x; gv[4 * c + 1] = b.y;
      gv[4 * c + 2] = b.z; gv[4 * c + 3] = b.w;
    }
  } else {
    const Vec32 in = load_elementwise(parts, L.part0, i0, n, part_n);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      pv[e] = in.p[e];
      gv[e] = in.g[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    step1(pv[e], gv[e], byte_at(qm, e), byte_at(qv, e), msc, vsc, h, m[e],
          v[e]);
  if (fast) {
    float4* pp = reinterpret_cast<float4*>(P.p + off);
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c)
      pp[c] = make_float4(pv[4 * c], pv[4 * c + 1], pv[4 * c + 2],
                          pv[4 * c + 3]);
  } else {
    Vec16 out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      out.x[e] = pv[e];
      if (i0 + e >= n) m[e] = v[e] = 0.f;
    }
    store_elementwise(parts, L.part0, i0, n, part_n, out);
  }

  // the row's absmax of m and v: warp shuffles, then the four warps
  float am = 0.f, av = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    am = fmaxf(am, fabsf(m[e]));
    av = fmaxf(av, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, o));
  }
  if (lane == 0) {
    red[0][warp] = am;
    red[1][warp] = av;
  }
  __syncthreads();  // also: every thread has read the row's ms and vs
  am = fmaxf(fmaxf(red[0][0], red[0][1]), fmaxf(red[0][2], red[0][3]));
  av = fmaxf(fmaxf(red[1][0], red[1][1]), fmaxf(red[1][2], red[1][3]));
  am = fmaxf(am, 1e-24f);
  av = fmaxf(av, 1e-24f);
  const float ram = __frcp_rn(am), rav = __frcp_rn(av);
  uint4 om, ov;
  om.x = quant4(m, am, ram, false);
  om.y = quant4(m + 4, am, ram, false);
  om.z = quant4(m + 8, am, ram, false);
  om.w = quant4(m + 12, am, ram, false);
  ov.x = quant4(v, av, rav, true);
  ov.y = quant4(v + 4, av, rav, true);
  ov.z = quant4(v + 8, av, rav, true);
  ov.w = quant4(v + 12, av, rav, true);
  *reinterpret_cast<uint4*>(L.mq + lrow * ROW + t * VEC) = om;
  *reinterpret_cast<uint4*>(L.vq + lrow * ROW + t * VEC) = ov;
  if (t == 0) {
    L.ms[lrow] = am;
    L.vs[lrow] = av;
  }
}

}  // namespace

// One fused 8-bit AdamW step over every leaf of `table` (device memory,
// int64 words: `nleaves` Leaf records of 8 words, then the Part records of
// 2 words each; see above), `rows` global rows in all, one block each.
// The caller checks the tensors: fp32 p and g, int8 (rows, 2048) moments,
// fp32 (rows,) scales, contiguous, p/g/mq/vq 16-byte aligned, n < 2^31.
// bc1/bc2 are the bias corrections 1 - b^step, omb1/omb2 = 1 - b1/b2.
// Returns cudaGetLastError() after the launch.
extern "C" int sdbc_adam8_leaves(const void* table, int nleaves,
                                 long long rows, float lr, float bc1,
                                 float bc2, float b1, float omb1, float b2,
                                 float omb2, float eps, float wd,
                                 void* stream) {
  if (nleaves <= 0 || rows <= 0 || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Leaf* leaves = static_cast<const Leaf*>(table);
  const Part* parts = reinterpret_cast<const Part*>(leaves + nleaves);
  const Hyper h{lr, 1.f / bc1, 1.f / sqrtf(bc2), b1, omb1, b2, omb2, eps, wd};
  adam8_leaves_kernel<<<(unsigned)rows, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(leaves, nleaves,
                                                             parts, h);
  return (int)cudaGetLastError();
}
