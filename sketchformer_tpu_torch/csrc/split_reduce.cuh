// The in-launch reduction of split partials shared by the kernels that cut
// a long contraction or reduction into slices (encoder_stack.cu's
// linear_tn, token_ce.cu's ce_dw, attention_train.cu's qk-norm gradients,
// norm_train.cu's layernorm_bwd): every block writes its f32
// partial tile to scratch; the block that finishes a tile last (a per-tile
// counter, reset by that block for the next launch, the only atomic) adds
// the partials z = 0 .. S-1 in that fixed order and writes the result, so
// re-runs are bit-stable and no second launch follows. Included into each
// source's anonymous namespace scope, as common.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

// the block's barrier: every thread of the block (kThreads 0), or threads
// 0 .. kThreads - 1 on named barrier kBar (a kernel whose other warps have
// exited)
template <int kBar = 0, int kThreads = 0>
__device__ __forceinline__ void split_sync() {
  if constexpr (kThreads == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"n"(kBar), "n"(kThreads) : "memory");
}

// The last block to finish a tile (of `splits`) gets true, with every
// other block's partials visible to it; it resets the tile's counter for
// the next launch. Every thread that split_sync counts calls it. Only
// thread 0 fences: the barrier orders the block's writes before its fence
// and counter add (release), and its fence after the add before the
// barrier that lets the block read (acquire), as a grid barrier does.
template <int kBar = 0, int kThreads = 0>
__device__ __forceinline__ bool split_last_block(unsigned* counter,
                                                 int splits, int* flag) {
  split_sync<kBar, kThreads>();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned seen = atomicAdd(counter, 1u);
    *flag = seen == (unsigned)splits - 1;
    if (*flag) *counter = 0u;
    __threadfence();
  }
  split_sync<kBar, kThreads>();
  return *flag != 0;
}

// the last block: out[r0 + r][c0 + c] = sum_z ws[z][r][c] in order z = 0..S-1
// (tiles of TR x TC f32, the splits' partials S tiles apart; out has K rows
// of N columns); with db, the same for the partial db rows ws_db[z][c].
// Threads 0 .. nthreads - 1 share the work
template <int TR, int TC>
__device__ void split_reduce(const float* __restrict__ ws, int splits,
                             float* __restrict__ out, int K, int N, int r0,
                             int c0, const float* __restrict__ ws_db,
                             float* __restrict__ db,
                             int nthreads = blockDim.x) {
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (int i = threadIdx.x; i < TR * TC / 4; i += nthreads) {
    const int r = i / (TC / 4), c = (i % (TC / 4)) * 4;
    if (r0 + r >= K || c0 + c >= N) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int z = 0; z < splits; ++z) {
      const float4 v = w4[(size_t)z * TR * TC / 4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    float* o = out + (size_t)(r0 + r) * N + c0 + c;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + c + j < N) o[j] = sv[j];
  }
  if (ws_db != nullptr)
    for (int c = threadIdx.x; c < TC; c += nthreads) {
      if (c0 + c >= N) continue;
      float s = 0.f;
      for (int z = 0; z < splits; ++z) s += ws_db[(size_t)z * TC + c];
      db[c0 + c] = s;
    }
}

// the last block, for partial rows of a width known only at run time:
// out[c] = sum_z ws[z * stride + c] in order z = 0..S-1, for c < n; one
// column a thread, sixteen splits' loads in flight
__device__ void split_reduce_row(const float* __restrict__ ws, int splits,
                                 size_t stride, float* __restrict__ out,
                                 int n) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 16
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * stride + c];
    out[c] = s;
  }
}

// split_reduce_row for many splits of narrow rows, over column quads: with
// n4 = ceil(n / 4) quads and P = min(splits, blockDim.x / n4, red_floats /
// (4 * n4)) parts, thread k * n4 + q adds quad q of the splits
// [k * S / P, (k + 1) * S / P) in order (16-byte loads, so a part's loads
// are in flight together) into red[k][q], then column c adds its P sums in
// order k = 0..P-1; the same order every run (a stride that is not a
// whole number of quads, or one part: split_reduce_row). ws 16-byte
// aligned, every partial row readable to 4 * n4 floats; red: red_floats
// f32 of 16-byte aligned shared memory that no thread still reads. Every
// thread of the block calls it.
__device__ void split_reduce_row_parts(const float* __restrict__ ws,
                                       int splits, size_t stride,
                                       float* __restrict__ out, int n,
                                       float* red, int red_floats) {
  const int n4 = (n + 3) / 4;
  const int P = min(splits, min((int)blockDim.x / n4, red_floats / (4 * n4)));
  if (P <= 1 || stride % 4 != 0) {
    split_reduce_row(ws, splits, stride, out, n);
    return;
  }
  const int k = threadIdx.x / n4, q = threadIdx.x % n4;
  if (k < P) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    const int z1 = (k + 1) * splits / P;
#pragma unroll 8
    for (int z = k * splits / P; z < z1; ++z) {
      const float4 v =
          reinterpret_cast<const float4*>(ws + (size_t)z * stride)[q];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    reinterpret_cast<float4*>(red)[k * n4 + q] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < P; ++j) s += red[j * 4 * n4 + c];
    out[c] = s;
  }
}

}  // namespace
