// The in-kernel dropout draw of the training kernels: a counter-based
// Philox-4x32-10 generator keyed by a 64-bit seed.
//
// Replaces the TPU's hardware PRNG draw, sketchformer_tpu/ops/
// pallas_dropout.py::draw_layer_bytes (prng_seed / prng_random_bits inside
// the stack kernels). What carries over is the requirement, not the bits:
// every kernel that reads a dropout site (the forward's epilogue, the
// backward's recompute, linear_nt, linear_tn, sum_rows) regenerates the
// same byte for the same element, whatever its tiling. So the byte is a
// pure function of the element's coordinates:
//
//   word(seed, stream, idx) = Philox4x32-10(key = seed,
//                                           counter = (idx >> 2, stream, 0, 0))
//                             [idx & 3]
//   stream = layer * kLayerStride + b,  idx = t * N + c
//
// for element (row m = b * T + t, column c) of an (M, N) site, and the byte
// of site k of that layer is byte k of the word (bits 8k .. 8k+7), as one
// TPU draw serves every site of a layer. An element drops when its byte is
// below round(rate * 256) (models/dropout.py). The Python side
// (ops/dropout_prng.py) has the same generator in plain torch, and the
// emit kernel (dropout_prng.cu) writes the bytes out.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLayerStride = 1u << 20;  // batch rows < 2^20 per layer

// one dropout site drawn in-kernel; T == 0 means no in-kernel draw
struct DropPrng {
  uint32_t k0, k1;   // the 64-bit seed, low and high word
  uint32_t stream0;  // layer * kLayerStride
  int shift;         // 8 * site
  int T;             // rows per batch element: m = b * T + t
};

inline DropPrng make_prng(unsigned long long seed, int layer, int site,
                          int T) {
  DropPrng p;
  p.k0 = (uint32_t)seed;
  p.k1 = (uint32_t)(seed >> 32);
  p.stream0 = (uint32_t)layer * kLayerStride;
  p.shift = 8 * site;
  p.T = T;
  return p;
}

// Philox-4x32-10 (Salmon et al., SC'11; the Random123 constants)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the Philox call that holds element (m, n) of an (M, N) site: the words of
// the four positions idx & ~3 .. (idx & ~3) + 3, idx = t * N + n
__device__ __forceinline__ uint4 prng_call(const DropPrng& p, int m, int n,
                                          int N, uint32_t* idx) {
  const int b = m / p.T, t = m - b * p.T;
  *idx = (uint32_t)t * (uint32_t)N + (uint32_t)n;
  return philox4x32_10(
      make_uint4(*idx >> 2, p.stream0 + (uint32_t)b, 0u, 0u), p.k0, p.k1);
}

// the byte of element (m, n) of an (M, N) site drawn in-kernel
__device__ __forceinline__ uint32_t prng_byte(const DropPrng& p, int m, int n,
                                              int N) {
  uint32_t idx;
  const uint4 r = prng_call(p, m, n, N, &idx);
  const uint32_t j = idx & 3u;
  const uint32_t w = j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
  return (w >> p.shift) & 255u;
}

// the words of elements (m, n .. n + 3), n and N multiples of 4: one call
// serves four bytes of one site (and of the layer's other sites)
__device__ __forceinline__ uint4 prng_words4(const DropPrng& p, int m, int n,
                                             int N) {
  uint32_t idx;
  return prng_call(p, m, n, N, &idx);
}

__device__ __forceinline__ bool has_drop(const uint8_t* drop,
                                         const DropPrng& p) {
  return drop != nullptr || p.T > 0;
}

// the dropout byte of element (m, n): read from the bytes tensor ('bits'
// mode) or drawn here ('prng' mode); the arithmetic after it is shared
__device__ __forceinline__ uint32_t drop_byte(const uint8_t* __restrict__ drop,
                                              const DropPrng& p, int m, int n,
                                              int N) {
  return drop != nullptr ? (uint32_t)drop[(size_t)m * N + n]
                         : prng_byte(p, m, n, N);
}

}  // namespace
