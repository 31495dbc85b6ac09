// Hopper (sm_90a) kernel for single-position attention against a
// head-folded KV cache: the composed AR decode path's self-attention.
//
// Replaces the TPU kernel sketchformer_tpu/ops/pallas_decode.py::
// decode_attention (body _decode_kernel). Each of the B*H folded rows holds
// one query position q (Dh values) and a (Tmax, Dh) cache of which the
// first cache_len positions are filled; positions >= cache_len are masked.
//
// What bounds it on the card: bytes. A call reads the filled part of the
// k and v caches once (2 * B*H * cache_len * Dh elements) and does two
// multiply-adds per element read, far below the card's operations per
// byte. So the design only keeps the reads coalesced and each row's scores
// on chip: one warp owns one folded row, its lanes take one cache position
// each for the scores (a 16-byte vector load per lane and step where the
// row width allows), the f32 score row stays in shared memory, and for
// P.V the lanes take the head dimensions so that one cache position is one
// contiguous read by the warp. Only the filled positions are read: a
// masked position's weight is exp(-1e9 - max) = 0 exactly, as in the TPU
// kernel, so skipping it changes nothing. cache_len is an argument, so one
// build serves every step.
//
// Numerics follow _decode_kernel: q, k and v in f32, scores summed in f32
// and then scaled, the softmax normalised in f32 before it multiplies v in
// f32; the output is rounded to the compute dtype once.
//
// The entry point returns cudaGetLastError() after its launch (0 = ok).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // one folded row per warp

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int BH,
                        int Tmax, int Dh, int len, float scale, int vec) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem + warp * Dh;                   // [kWarps][Dh]
  float* sc = smem + kWarps * Dh + warp * Tmax;   // [kWarps][Tmax]
  const int row = blockIdx.x * kWarps + warp;
  if (row >= BH) return;  // no block-wide barrier below
  const T* kr = k + (size_t)row * Tmax * Dh;
  const T* vr = v + (size_t)row * Tmax * Dh;
  for (int d = lane; d < Dh; d += 32) qs[d] = to_f<T>(q[(size_t)row * Dh + d]);
  __syncwarp();

  constexpr int VW = 16 / sizeof(T);
  for (int p = lane; p < len; p += 32) {
    const T* kp = kr + (size_t)p * Dh;
    float s = 0.f;
    if (vec) {
      for (int d0 = 0; d0 < Dh; d0 += VW) {
        const uint4 u = *reinterpret_cast<const uint4*>(kp + d0);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int c = 0; c < VW; ++c) s = fmaf(qs[d0 + c], to_f<T>(e[c]), s);
      }
    } else {
      for (int d = 0; d < Dh; ++d) s = fmaf(qs[d], to_f<T>(kp[d]), s);
    }
    sc[p] = s * scale;
  }
  float m = -INFINITY;
  for (int p = lane; p < len; p += 32) m = fmaxf(m, sc[p]);
  m = warp_max(m);
  float sum = 0.f;
  for (int p = lane; p < len; p += 32) {
    const float e = expf(sc[p] - m);
    sc[p] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  __syncwarp();

  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int p = 0; p < len; ++p) {
    const float w = sc[p] / sum;
    const T* vp = vr + (size_t)p * Dh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) acc[i] = fmaf(w, to_f<T>(vp[d]), acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) out[(size_t)row * Dh + d] = from_f<T>(acc[i]);
  }
}

template <typename T, int NI>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Tmax, int Dh, int len, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * (Dh + Tmax);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, NI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int VW = 16 / sizeof(T);
  const int vec = Dh % VW == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const dim3 grid((BH + kWarps - 1) / kWarps);
  decode_attention_kernel<T, NI><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH, Tmax, Dh, len,
      scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int BH,
              int Tmax, int Dh, int len, float scale, cudaStream_t stream) {
  if (Dh <= 32)
    return launch<T, 1>(q, k, v, out, BH, Tmax, Dh, len, scale, stream);
  if (Dh <= 64)
    return launch<T, 2>(q, k, v, out, BH, Tmax, Dh, len, scale, stream);
  if (Dh <= 128)
    return launch<T, 4>(q, k, v, out, BH, Tmax, Dh, len, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int sk_decode_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int BH, int Tmax,
                                   int Dh, int len, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len < 1 || len > Tmax) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, BH, Tmax, Dh, len, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, BH, Tmax, Dh, len, scale,
                                    s);
  return (int)cudaErrorInvalidValue;
}
