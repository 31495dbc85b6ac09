// Hopper (sm_90a) kernels for single-position attention against a
// head-folded KV cache: the composed AR decode path's self-attention (every
// sampled decode, and every post-LN decode).
//
// Replaces the TPU kernel sketchformer_tpu/ops/pallas_decode.py::
// decode_attention (body _decode_kernel). Each of the B*H folded rows holds
// one query position q (Dh values) and a (Tmax, Dh) cache of which the
// first cache_len positions are filled; positions >= cache_len are masked.
//
// What bounds it on the card: bytes. A call reads the filled part of the
// k and v caches once (2 * B*H * cache_len * Dh elements) and does two
// multiply-adds per element read, far below the card's operations per
// byte; at the decode's B*H = 512, Dh = 32 that is 6.3 MB at cache_len 96,
// under 2 us of memory time, so one launch and one memory round trip set
// the floor. Only the filled positions are read: a masked position's
// weight is exp(-1e9 - max) = 0 exactly, as in the TPU kernel, so skipping
// it changes nothing. cache_len is an argument, so one build serves every
// step.
//
//   decode_attention_bulk_kernel  (the plan of ops/decode_attention.py::
//     decode_attention_plan; Dh * sizeof(T) a multiple of 16 bytes, its
//     16-byte vectors a power of two, every operand 16-byte aligned, a row
//     within shared memory). A block holds `rows` folded rows, each split
//     over `splits` warps that own consecutive spans of `span` positions.
//     The filled part of a row's k and of its v are each one contiguous
//     span, so a warp's share of each lands in shared memory by one 1-D
//     bulk copy (cp.async.bulk on an mbarrier) issued by its lane 0 at the
//     start: every byte the block needs is in flight at once, k and v on
//     their own barriers so the scores start while v still arrives. Lanes
//     take (position, 16-byte vector) pairs, so a warp reads 512
//     consecutive bytes of a staged span a step: the scores' partial dots
//     reduce over a position's lanes by shuffles, and P.V keeps each lane's
//     vector of the output in f32 and reduces over the positions by
//     shuffles. Each warp keeps its span's (max, sum, partial o); the split
//     warps of a row merge them through shared memory and divide by the sum
//     once, at the end. Grid: ceil(B*H / rows) blocks.
//   decode_attention_kernel  (every other geometry: the card test's
//     Dh = 24, a misaligned operand, a row past shared memory) one warp per
//     folded row, eight a block: lanes take one cache position each for the
//     scores, the f32 score row stays in shared memory, and for P.V the
//     lanes take the head dimensions, one cache position after another.
//
// Numerics follow _decode_kernel: q, k and v in f32, scores summed in f32
// and then scaled, an f32 softmax and f32 products; the output is rounded
// to the compute dtype once. The split kernel's merged softmax differs from
// it only by summation order and by dividing the f32 sum of e * v (not
// each weight) by the sum.
//
// The entry point returns cudaGetLastError() after its launch (0 = ok).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // one folded row per warp
constexpr int kBulkThreads = 256;      // rows * splits warps, at most
constexpr int kSmemLimit = 232448;     // opt-in shared memory of a block

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

// the bulk kernel's shared memory: the barriers (two a warp, rounded up to
// 128 bytes), then for each of the block's rows its staged k and v spans
// (splits * span positions each), then each row's scores, then each (row,
// split)'s (max, sum, o[Dh]) in f32; ops/decode_attention.py::
// decode_attention_plan computes the same size
size_t bulk_smem_bytes(int rows, int splits, int span, int Dh, int esize) {
  const size_t bars = ((size_t)16 * rows * splits + 127) / 128 * 128;
  const size_t n = (size_t)splits * span;
  return bars + rows * (2 * n * Dh * esize + n * 4 +
                        (size_t)splits * (Dh + 2) * 4);
}

template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
decode_attention_bulk_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int BH, int Tmax, int Dh, int len, float scale,
                             int rows, int splits, int span) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  constexpr int VW = 16 / sizeof(T);  // elements of a 16-byte vector
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / splits, sp = warp - r * splits;
  const int row = blockIdx.x * rows + r;
  const bool live = row < BH;
  // lane = j * nv + c: vector c of position j of the current step's P
  const int nv = Dh / VW, P = 32 / nv;
  const int c = lane & (nv - 1), j = lane / nv;
  const int n_row = splits * span;  // staged positions a row
  uint64_t* bars = reinterpret_cast<uint64_t*>(bulk_smem);
  T* stage = reinterpret_cast<T*>(
      bulk_smem + ((size_t)16 * rows * splits + 127) / 128 * 128);
  T* ks = stage + (size_t)r * 2 * n_row * Dh;
  T* vs = ks + (size_t)n_row * Dh;
  float* sc_all =
      reinterpret_cast<float*>(stage + (size_t)rows * 2 * n_row * Dh);
  float* sc = sc_all + (size_t)r * n_row;
  float* part = sc_all + (size_t)rows * n_row;  // [rows][splits][Dh + 2]
  const int p0 = sp * span;
  const int n = live ? max(0, min(span, len - p0)) : 0;  // warp-uniform
  const uint32_t bar_k = smem_u32(bars + 2 * warp);
  const uint32_t bar_v = smem_u32(bars + 2 * warp + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * rows * splits; ++i)
      mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (lane == 0 && n > 0) {
    const uint32_t bytes = (uint32_t)n * Dh * sizeof(T);
    const size_t off = ((size_t)row * Tmax + p0) * Dh;
    mbar_arrive_expect_tx(bar_k, bytes);
    bulk_load(smem_u32(ks + (size_t)p0 * Dh), k + off, bytes, bar_k);
    mbar_arrive_expect_tx(bar_v, bytes);
    bulk_load(smem_u32(vs + (size_t)p0 * Dh), v + off, bytes, bar_v);
  }
  // this lane's vector of q in f32, read while the spans land
  float qf[VW];
  {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (live)
      u = *reinterpret_cast<const uint4*>(q + (size_t)row * Dh + c * VW);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VW; ++i) qf[i] = to_f<T>(e[i]);
  }

  float m = -INFINITY, l = 0.f, acc[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i) acc[i] = 0.f;
  if (n > 0) {
    mbar_wait(bar_k, 0);
    for (int b0 = 0; b0 < n; b0 += P) {
      const int p = b0 + j;
      float s = 0.f;
      if (p < n) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            ks + (size_t)(p0 + p) * Dh + c * VW);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < VW; ++i) s = fmaf(qf[i], to_f<T>(e[i]), s);
      }
      for (int o = nv >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (c == 0 && p < n) sc[p0 + p] = s * scale;
    }
    __syncwarp();
    for (int p = lane; p < n; p += 32) m = fmaxf(m, sc[p0 + p]);
    m = warp_max(m);
    for (int p = lane; p < n; p += 32) {
      const float e = expf(sc[p0 + p] - m);
      sc[p0 + p] = e;
      l += e;
    }
    l = warp_sum(l);
    __syncwarp();
    mbar_wait(bar_v, 0);
    for (int b0 = 0; b0 < n; b0 += P) {
      const int p = b0 + j;
      if (p < n) {
        const float w = sc[p0 + p];
        const uint4 u = *reinterpret_cast<const uint4*>(
            vs + (size_t)(p0 + p) * Dh + c * VW);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(w, to_f<T>(e[i]), acc[i]);
      }
    }
    // add the positions' lanes: lanes j * nv + c hold vector c
    for (int o = nv; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < VW; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
  }
  T* dst = out + (size_t)row * Dh + c * VW;
  if (splits == 1) {  // uniform over the block: no barrier follows
    if (live && j == 0) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < VW; ++i) e[i] = from_f<T>(acc[i] / l);
      *reinterpret_cast<uint4*>(dst) = u;
    }
    return;
  }
  float* own = part + ((size_t)r * splits + sp) * (Dh + 2);
  if (lane == 0) {
    own[0] = m;
    own[1] = l;
  }
  if (j == 0) {
#pragma unroll
    for (int i = 0; i < VW; ++i) own[2 + c * VW + i] = acc[i];
  }
  __syncthreads();
  if (sp != 0 || !live || j != 0) return;
  // the row's first split warp merges the splits in order: each rescaled
  // by exp(its max - the row's max) (0 for a split with no position)
  const float* pr = part + (size_t)r * splits * (Dh + 2);
  float mx = -INFINITY;
  for (int t = 0; t < splits; ++t) mx = fmaxf(mx, pr[t * (Dh + 2)]);
  float sum = 0.f, o[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i) o[i] = 0.f;
  for (int t = 0; t < splits; ++t) {
    const float* pt = pr + t * (Dh + 2);
    const float w = expf(pt[0] - mx);
    sum = fmaf(pt[1], w, sum);
#pragma unroll
    for (int i = 0; i < VW; ++i) o[i] = fmaf(pt[2 + c * VW + i], w, o[i]);
  }
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < VW; ++i) e[i] = from_f<T>(o[i] / sum);
  *reinterpret_cast<uint4*>(dst) = u;
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

// the plan of ops/decode_attention.py::decode_attention_plan; refused
// (invalid value) unless it covers the filled positions of every row
// within the block and shared-memory limits and every operand suits the
// 16-byte vectors and bulk copies
template <typename T>
int launch_bulk(const void* q, const void* k, const void* v, void* out,
                int BH, int Tmax, int Dh, int len, float scale, int rows,
                int splits, int span, int smem, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const int nv = Dh / VW;
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (Dh % VW != 0 || nv < 1 || nv > 32 || (nv & (nv - 1)) != 0 ||
      rows < 1 || splits < 1 || rows * splits * 32 > kBulkThreads ||
      span < 1 || (long long)splits * span < len ||
      (long long)(splits - 1) * span >= len || smem > kSmemLimit ||
      (size_t)smem < bulk_smem_bytes(rows, splits, span, Dh, sizeof(T)) ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  static bool opted = false;  // the largest size, once
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_bulk_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  decode_attention_bulk_kernel<T>
      <<<(BH + rows - 1) / rows, rows * splits * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), BH, Tmax, Dh, len,
          scale, rows, splits, span);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. rows = 0: the per-row kernel
// (a declined geometry); else the bulk kernel on the plan (rows, splits,
// span, smem bytes)
extern "C" int sk_decode_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int BH, int Tmax,
                                   int Dh, int len, float scale, int rows,
                                   int splits, int span, int smem,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len < 1 || len > Tmax) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    if (dtype == 0)
      return launch_bulk<float>(q, k, v, out, BH, Tmax, Dh, len, scale, rows,
                                splits, span, smem, s);
    if (dtype == 1)
      return launch_bulk<__nv_bfloat16>(q, k, v, out, BH, Tmax, Dh, len,
                                        scale, rows, splits, span, smem, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, BH, Tmax, Dh, len, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, BH, Tmax, Dh, len, scale,
                                    s);
  return (int)cudaErrorInvalidValue;
}
