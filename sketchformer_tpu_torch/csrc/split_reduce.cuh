// The in-launch reduction of split partials shared by the kernels that cut
// a long contraction into slices (encoder_stack.cu's linear_tn, token_ce.cu's
// ce_dw): every block writes its f32 partial tile to scratch; the block that
// finishes a tile last (a per-tile counter, reset by that block for the next
// launch, the only atomic) adds the partials z = 0 .. S-1 in that fixed
// order and writes the result, so re-runs are bit-stable and no second
// launch follows. Included into each source's anonymous namespace scope, as
// common.cuh.

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

// The last block to finish a tile (of `splits`) gets true, after a fence
// that makes every other block's partials visible to it; it resets the
// tile's counter for the next launch. Every thread that split_sync
// counts calls it.
template <int kBar = 0, int kThreads = 0>
__device__ __forceinline__ bool split_last_block(unsigned* counter,
                                                 int splits, int* flag) {
  __threadfence();
  split_sync<kBar, kThreads>();
  if (threadIdx.x == 0) {
    const unsigned seen = atomicAdd(counter, 1u);
    *flag = seen == (unsigned)splits - 1;
    if (*flag) *counter = 0u;
  }
  split_sync<kBar, kThreads>();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
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

}  // namespace
