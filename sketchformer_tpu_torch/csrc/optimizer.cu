// Hopper (sm_90a) multi-tensor kernels of the optimizer step: the global
// gradient norm, the non-finite guard, the clip, the Noam rate and the Adam
// update, with no value read on the host.
//
// Replaces no TPU kernel: the JAX package's optax chain
// (sketchformer_tpu/train/schedule.py::make_optimizer, clip_by_global_norm
// then adam at the Noam rate) and its guard (train/step.py, a select on
// the device) compile under jit into XLA's fused loops. Eagerly on the
// card the same step was one launch a tensor and a chain of multi-tensor
// ops issued only after the host had read whether the norm was finite;
// these three launches take its place.
//
//   global_sumsq  one launch over every gradient tensor: blocks take fixed
//                 chunks of the tensors' concatenated element space (a
//                 binary search over the tensors' start offsets finds the
//                 first tensor of a chunk), sum the squares in f64 (each
//                 f32 square is exact in f64) and write one partial a
//                 block; the last block to finish (a ticket, reset by that
//                 block) adds the partials in a fixed order and writes the
//                 f32 norm, inf where the sum overflows f32 (optax sums the
//                 squares in f32, so the guard skips the steps it skips).
//                 Re-runs are bit-stable.
//   adam_prepare  one thread: the finite flag, the Noam rate at the count
//                 before the increment (f32, as noam_schedule computes it),
//                 the bias corrections at the count after it (an f64 pow,
//                 rounded to f32, as the plain route), the applied flag and,
//                 when the norm is finite, the count's increment. The update
//                 launch that follows reads only what it wrote, never the
//                 count.
//   adam_update   one block a fixed chunk of the concatenated space of the
//                 (param, grad, mu, nu) quadruples; every block returns at
//                 once when the flag says the norm was not finite. Each
//                 element, in f32 with every rounding where the plain route
//                 has it (no contraction): g <- norm < clip ? g : g / norm
//                 * clip; mu <- b1 mu + (1 - b1) g; nu <- b2 nu + (1 - b2)
//                 g g; p <- p + (-lr) ((mu / bc1) / (sqrt(nu / bc2) + eps)).
//
// The tensors' pointers and start offsets travel in the kernel parameters
// (up to 32,764 bytes from CUDA 12.1 on: kMaxTensors quadruples), so no
// table is copied to the device a step; a longer list is split across
// launches by the wrapper (ops/optimizer.py). A segment of a tensor inside
// a chunk is read with 16-byte vectors where all its operands share one
// alignment (a scalar head up to it, a scalar tail), else element by
// element (a data-parallel gradient is a view of one flat buffer, at any
// offset).
//
// Bound by memory: the norm reads each gradient once (4 bytes an element),
// the update reads p, g, mu, nu and writes p, mu, nu once (28 bytes).
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <stdint.h>

#include "common.cuh"
#include "split_reduce.cuh"

namespace {

constexpr int kMaxTensors = 512;  // tensors a launch (ops/optimizer.py)
constexpr int kThreads = 256;
constexpr int kChunk = 4096;      // elements of the concatenated space

struct NormTable {
  const float* g[kMaxTensors];
  long long start[kMaxTensors + 1];  // start[n] = the elements of all
  int n;
};

struct AdamTable {
  const float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long start[kMaxTensors + 1];
  int n;
};

// the largest t < n with start[t] <= e: the tensor holding element e of
// the concatenated space (a tensor of no elements is never the largest)
__device__ __forceinline__ int find_tensor(const long long* start, int n,
                                           long long e) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= e)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// elements [0, head) scalar, then whole 16-byte vectors, then the tail;
// head = the elements before addr's next 16-byte boundary
__device__ __forceinline__ int vector_head(uintptr_t addr, long long n) {
  const int h = (int)(((16u - (unsigned)(addr & 15u)) & 15u) >> 2);
  return n < h ? (int)n : h;
}

// a fixed-order sum over the block's threads (butterflies, then the warps
// in order); the result is in every thread. The shared buffer is free
// again when it returns.
__device__ double block_sum(double v) {
  __shared__ double warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += warps[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ double sq(float x) {
  const double d = (double)x;
  return d * d;
}

// this thread's share of the sum of squares of x[0, n)
__device__ double segment_sumsq(const float* __restrict__ x, long long n) {
  double acc = 0.0;
  const int head = vector_head((uintptr_t)x, n);
  if ((int)threadIdx.x < head) acc += sq(x[threadIdx.x]);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const long long nv = (n - head) >> 2;
#pragma unroll 4
  for (long long i = threadIdx.x; i < nv; i += kThreads) {
    const float4 q = __ldg(x4 + i);
    acc += sq(q.x) + sq(q.y) + sq(q.z) + sq(q.w);
  }
  const long long tail = head + 4 * nv;
  if (threadIdx.x < n - tail) acc += sq(x[tail + threadIdx.x]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    global_sumsq_kernel(const __grid_constant__ NormTable tab,
                        double* __restrict__ partials, int part_base,
                        int total_parts, unsigned* ticket,
                        float* __restrict__ norm, int finalize) {
  const long long total = tab.start[tab.n];
  const long long chunks = (total + kChunk - 1) / kChunk;
  double acc = 0.0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long c0 = c * kChunk;
    const long long c1 = c0 + kChunk < total ? c0 + kChunk : total;
    for (int t = find_tensor(tab.start, tab.n, c0);
         t < tab.n && tab.start[t] < c1; ++t) {
      const long long s = tab.start[t];
      const long long a = (c0 > s ? c0 : s) - s;
      const long long b = (c1 < tab.start[t + 1] ? c1 : tab.start[t + 1]) - s;
      acc += segment_sumsq(tab.g[t] + a, b - a);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[part_base + blockIdx.x] = acc;
  if (!finalize) return;
  __shared__ int last;
  if (!split_last_block(ticket, gridDim.x, &last)) return;
  double s = 0.0;
  for (int i = threadIdx.x; i < total_parts; i += kThreads)
    s += __ldcg(partials + i);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    const float s32 = (float)s;  // inf (or NaN) where optax's sum is
    *norm = isfinite(s32) ? (float)sqrt(s) : s32;
  }
}

__global__ void adam_prepare_kernel(const float* __restrict__ norm,
                                    long long* __restrict__ count,
                                    float* __restrict__ scalars,
                                    float* __restrict__ applied,
                                    float rate_scale, float rate_warm,
                                    double b1, double b2) {
  const bool finite = isfinite(*norm);
  const long long c = *count;
  // noam_schedule: scale * min(step^-0.5, step * warm), step = max(c, 1)
  const float step = (float)(c < 1 ? 1 : c);
  const float lr = __fmul_rn(
      rate_scale, fminf(__fdiv_rn(1.0f, __fsqrt_rn(step)),
                        __fmul_rn(step, rate_warm)));
  const double after = (double)(c + 1);
  scalars[0] = finite ? 1.0f : 0.0f;
  scalars[1] = lr;
  scalars[2] = (float)(1.0 - pow(b1, after));
  scalars[3] = (float)(1.0 - pow(b2, after));
  *applied = finite ? 1.0f : 0.0f;
  if (finite) *count = c + 1;
}

struct AdamScalars {
  float norm, clip, b1, omb1, b2, omb2, eps, neg_lr, bc1, bc2;
  bool clipped;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m,
                                             float& v, const AdamScalars& s) {
  if (s.clipped) g = __fmul_rn(__fdiv_rn(g, s.norm), s.clip);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den), s.neg_lr));
}

__device__ __forceinline__ void adam_at(float* p, const float* g, float* m,
                                        float* v, long long i,
                                        const AdamScalars& s) {
  float pi = p[i], mi = m[i], vi = v[i];
  adam_element(pi, g[i], mi, vi, s);
  p[i] = pi;
  m[i] = mi;
  v[i] = vi;
}

__device__ void segment_adam(float* __restrict__ p,
                             const float* __restrict__ g,
                             float* __restrict__ m, float* __restrict__ v,
                             long long n, const AdamScalars& s) {
  const uintptr_t ap = (uintptr_t)p;
  const bool same = ((ap ^ (uintptr_t)g) | (ap ^ (uintptr_t)m) |
                     (ap ^ (uintptr_t)v)) % 16u == 0;
  if (!same) {
    for (long long i = threadIdx.x; i < n; i += kThreads)
      adam_at(p, g, m, v, i, s);
    return;
  }
  const int head = vector_head(ap, n);
  if ((int)threadIdx.x < head) adam_at(p, g, m, v, threadIdx.x, s);
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  float4* m4 = reinterpret_cast<float4*>(m + head);
  float4* v4 = reinterpret_cast<float4*>(v + head);
  const long long nv = (n - head) >> 2;
  for (long long i = threadIdx.x; i < nv; i += kThreads) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = __ldg(g4 + i);
    adam_element(pp.x, gg.x, mm.x, vv.x, s);
    adam_element(pp.y, gg.y, mm.y, vv.y, s);
    adam_element(pp.z, gg.z, mm.z, vv.z, s);
    adam_element(pp.w, gg.w, mm.w, vv.w, s);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  const long long tail = head + 4 * nv;
  if (threadIdx.x < n - tail) adam_at(p, g, m, v, tail + threadIdx.x, s);
}

__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ AdamTable tab,
                       const float* __restrict__ norm,
                       const float* __restrict__ scalars, float clip,
                       float b1, float omb1, float b2, float omb2,
                       float eps) {
  if (scalars[0] == 0.0f) return;  // the norm was not finite: no update
  AdamScalars s;
  s.norm = *norm;
  s.clipped = !(s.norm < clip);
  s.clip = clip;
  s.b1 = b1;
  s.omb1 = omb1;
  s.b2 = b2;
  s.omb2 = omb2;
  s.eps = eps;
  s.neg_lr = -scalars[1];
  s.bc1 = scalars[2];
  s.bc2 = scalars[3];
  const long long total = tab.start[tab.n];
  const long long c0 = (long long)blockIdx.x * kChunk;
  const long long c1 = c0 + kChunk < total ? c0 + kChunk : total;
  for (int t = find_tensor(tab.start, tab.n, c0);
       t < tab.n && tab.start[t] < c1; ++t) {
    const long long st = tab.start[t];
    const long long a = (c0 > st ? c0 : st) - st;
    const long long b = (c1 < tab.start[t + 1] ? c1 : tab.start[t + 1]) - st;
    segment_adam(tab.p[t] + a, tab.g[t] + a, tab.m[t] + a, tab.v[t] + a,
                 b - a, s);
  }
}

// the table's start offsets: a group's prefix sums of element counts,
// rebased to its first (start[t] - start[0]); false when n is out of range
// or a start decreases
bool fill_starts(long long* dst, const long long* start, int n) {
  if (n < 1 || n > kMaxTensors) return false;
  for (int t = 0; t <= n; ++t) {
    if (t > 0 && start[t] < start[t - 1]) return false;
    dst[t] = start[t] - start[0];
  }
  return true;
}

}  // namespace

extern "C" {

// g: n f32 pointers; start: n + 1 prefix sums of their element counts
// (start[n] - start[0] = the elements); blocks from ops/optimizer.py::norm_blocks; partials: f64
// scratch, this launch's at [part_base, part_base + blocks); the launch
// with finalize = 1 (the last of a split list) adds the total_parts
// partials and writes the f32 norm; ticket: one zeroed counter (its last
// block resets it)
int sk_global_sumsq(int n, const void* const* g, const long long* start,
                    int blocks, void* partials, int part_base,
                    int total_parts, void* ticket, void* norm, int finalize,
                    void* stream) {
  NormTable tab;
  if (!fill_starts(tab.start, start, n) || blocks < 1 ||
      part_base + blocks > total_parts)
    return (int)cudaErrorInvalidValue;
  tab.n = n;
  for (int t = 0; t < n; ++t) tab.g[t] = static_cast<const float*>(g[t]);
  global_sumsq_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<double*>(partials), part_base, total_parts,
      static_cast<unsigned*>(ticket), static_cast<float*>(norm), finalize);
  return (int)cudaGetLastError();
}

// count: an int64 on the device; scalars: 4 f32 (flag, lr, bc1, bc2);
// applied: one f32 (1 when the update applies)
int sk_adam_prepare(const void* norm, void* count, void* scalars,
                    void* applied, float rate_scale, float rate_warm,
                    double b1, double b2, void* stream) {
  adam_prepare_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(norm), static_cast<long long*>(count),
      static_cast<float*>(scalars), static_cast<float*>(applied), rate_scale,
      rate_warm, b1, b2);
  return (int)cudaGetLastError();
}

// g, p, m, v: n f32 pointers each (a tensor's gradient, parameter and
// moments, each of start[t + 1] - start[t] elements); scalars from
// sk_adam_prepare on the same stream
int sk_adam_update(int n, const void* const* g, void* const* p,
                   void* const* m, void* const* v, const long long* start,
                   const void* norm, const void* scalars, float clip,
                   float b1, float omb1, float b2, float omb2, float eps,
                   void* stream) {
  AdamTable tab;
  if (!fill_starts(tab.start, start, n)) return (int)cudaErrorInvalidValue;
  tab.n = n;
  for (int t = 0; t < n; ++t) {
    tab.g[t] = static_cast<const float*>(g[t]);
    tab.p[t] = static_cast<float*>(p[t]);
    tab.m[t] = static_cast<float*>(m[t]);
    tab.v[t] = static_cast<float*>(v[t]);
  }
  const long long chunks = (tab.start[n] + kChunk - 1) / kChunk;
  if (chunks < 1) return 0;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adam_update_kernel<<<(unsigned)chunks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const float*>(norm),
      static_cast<const float*>(scalars), clip, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
