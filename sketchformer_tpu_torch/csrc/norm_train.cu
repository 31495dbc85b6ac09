// Hopper (sm_90a) kernels for the LayerNorm backward and the fixed-order
// reductions of the training stacks.
//
// Replaces, inside sketchformer_tpu/ops/pallas_encoder_train.py::
// _layer_bwd_kernel and sketchformer_tpu/ops/pallas_decoder_train.py::
// _dec_layer_bwd_kernel, the LayerNorm backward (_ln_bwd32) with its
// residual add, and the accumulation of bias and LayerNorm parameter
// gradients across grid cells (the TPU kernels revisit one output block
// across a sequential grid; blocks here run in parallel, so each writes a
// partial row and sum_rows adds the partial rows in a fixed order).
//
//   layernorm_bwd  one warp per row, 8 rows per warp: recomputes the row's
//                  f32 statistics from x (var = max(E[x^2] - mu^2, 0), eps
//                  1e-6, as the forward), dxhat = dy * scale, dx = rstd *
//                  (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), adds
//                  the residual gradient and writes f32 or the compute
//                  dtype; the block's partial sums of dy * xhat and dy go to
//                  one row each of the partial buffers.
//   sum_rows       out[c] = sum over rows r of x[r, c], lanes over columns,
//                  warps over rows and a fixed-order pass over the warps;
//                  with splits > 1 it writes split partial rows that a
//                  second launch adds. (The bias gradients are linear_tn's,
//                  encoder_stack.cu.)
//
// Both are bound by memory: each reads its operands once.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;

template <typename T, typename TR, typename TO>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ scale,
                     const TR* __restrict__ resid, TO* __restrict__ dx,
                     float* __restrict__ part_s, float* __restrict__ part_b,
                     int M, int D) {
  extern __shared__ float red[];  // [2][kWarps][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = red + warp * D;
  float* wb = red + (kWarps + warp) * D;
  for (int c = lane; c < D; c += 32) ws[c] = wb[c] = 0.f;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int m = row0 + rr;
    if (m >= M) break;
    const T* xr = x + (size_t)m * D;
    const float* gr = dy + (size_t)m * D;
    float sum = 0.f, ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_f<T>(xr[c]);
      sum += v;
      ss += v * v;
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mu = sum / D;
    const float rstd = 1.f / sqrtf(fmaxf(ss / D - mu * mu, 0.f) + kLnEps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xh = (to_f<T>(xr[c]) - mu) * rstd;
      const float g = gr[c], dxh = g * scale[c];
      m1 += dxh;
      m2 += dxh * xh;
      ws[c] += g * xh;
      wb[c] += g;
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    for (int c = lane; c < D; c += 32) {
      const float xh = (to_f<T>(xr[c]) - mu) * rstd;
      float v = rstd * (gr[c] * scale[c] - m1 - xh * m2);
      if (resid != nullptr) v = to_f<TR>(resid[(size_t)m * D + c]) + v;
      dx[(size_t)m * D + c] = from_f<TO>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * D + c];
      b += red[(kWarps + w) * D + c];
    }
    part_s[(size_t)blockIdx.x * D + c] = a;
    part_b[(size_t)blockIdx.x * D + c] = b;
  }
}

template <typename TI>
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const TI* __restrict__ x, float* __restrict__ out, int R,
                int N, int rows_per_split) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(R, r0 + rows_per_split);
  float acc = 0.f;
  if (c < N) {
    for (int r = r0 + warp; r < r1; r += kWarps) {
      acc += to_f<TI>(x[(size_t)r * N + c]);
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < N) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][lane];
    out[(size_t)blockIdx.y * N + c] = s;
  }
}

template <typename T>
int launch_ln_bwd(int resid_code, int out_f32, const void* x, const void* dy,
                  const void* scale, const void* resid, void* dx,
                  void* part_s, void* part_b, int M, int D,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kWarps * D;
  const dim3 grid((M + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp));
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(dy);
  const float* sp = static_cast<const float*>(scale);
  float* ps = static_cast<float*>(part_s);
  float* pb = static_cast<float*>(part_b);
#define SK_LN(TR, TO)                                                        \
  {                                                                          \
    auto k = layernorm_bwd_kernel<T, TR, TO>;                                \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);          \
    if (e != cudaSuccess) return (int)e;                                     \
    k<<<grid, kThreads, smem, stream>>>(xp, gp, sp,                          \
                                        static_cast<const TR*>(resid),       \
                                        static_cast<TO*>(dx), ps, pb, M, D); \
  }
  // resid_code: 0 f32 residual (or none), 1 residual in the compute dtype
  if (resid_code == 0 && out_f32) SK_LN(float, float)
  else if (resid_code == 0) SK_LN(float, T)
  else if (out_f32) SK_LN(T, float)
  else SK_LN(T, T)
#undef SK_LN
  return (int)cudaGetLastError();
}

template <typename TI>
int launch_sum_rows(const void* x, void* out, int R, int N, int splits,
                    cudaStream_t stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int rps = (R + splits - 1) / splits;
  const dim3 grid((N + 31) / 32, splits);
  sum_rows_kernel<TI><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<float*>(out), R, N, rps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" {

int sk_layernorm_bwd(int dtype, int resid_code, int out_f32, const void* x,
                     const void* dy, const void* scale, const void* resid,
                     void* dx, void* part_s, void* part_b, int M, int D,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ln_bwd<float>(resid_code, out_f32, x, dy, scale, resid, dx,
                                part_s, part_b, M, D, s);
  if (dtype == 1)
    return launch_ln_bwd<__nv_bfloat16>(resid_code, out_f32, x, dy, scale,
                                        resid, dx, part_s, part_b, M, D, s);
  return (int)cudaErrorInvalidValue;
}

// in_code: 0 float32 rows, 1 bfloat16 rows
int sk_sum_rows(int in_code, const void* x, void* out, int R, int N,
                int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0) return launch_sum_rows<float>(x, out, R, N, splits, s);
  if (in_code == 1)
    return launch_sum_rows<__nv_bfloat16>(x, out, R, N, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
