// Hopper (sm_90a) kernel that writes the training kernels' in-kernel
// dropout bytes out as a tensor.
//
// Replaces the TPU kernel sketchformer_tpu/ops/pallas_dropout.py::
// emit_dropout_bits (_emit_kernel): out[layer * nsites + k, b, t, c] is byte
// k of the Philox word of (seed, layer * kLayerStride + b, t * d + c), the
// byte that a 'prng' mode kernel draws for site k of that layer
// (dropout_prng.cuh). Fed to the 'bits' mode kernels it must reproduce the
// 'prng' mode bit for bit, which is how the in-kernel draw is held. The
// port also draws the bytes of its composed dropout sites on the card with
// it (one layer, one site).
//
// One thread computes one Philox call: four consecutive (t, c) positions of
// one batch row, and writes their bytes of every site (4-byte stores where
// the plane allows). What bounds it on the card: the bytes it writes, one
// per element and site; the Philox rounds (integer multiplies) come second.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <stdint.h>

#include "dropout_prng.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
emit_dropout_bits_kernel(uint32_t k0, uint32_t k1, uint8_t* __restrict__ out,
                         int nsites, int B, int TD) {
  const int g = blockIdx.x * kThreads + threadIdx.x;  // group of 4 positions
  const int idx0 = 4 * g;
  if (idx0 >= TD) return;
  const int b = blockIdx.y, layer = blockIdx.z;
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)layer * kLayerStride + (uint32_t)b, 0u,
                 0u),
      k0, k1);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  const bool full = idx0 + 4 <= TD && (TD & 3) == 0;
  for (int k = 0; k < nsites; ++k) {
    uint8_t* dst =
        out + ((size_t)(layer * nsites + k) * B + b) * (size_t)TD + idx0;
    const int s = 8 * k;
    if (full) {
      *reinterpret_cast<uchar4*>(dst) =
          make_uchar4((w[0] >> s) & 255u, (w[1] >> s) & 255u,
                      (w[2] >> s) & 255u, (w[3] >> s) & 255u);
    } else {
      for (int j = 0; j < 4 && idx0 + j < TD; ++j) dst[j] = (w[j] >> s) & 255u;
    }
  }
}

}  // namespace

extern "C" {

// out: (num_layers * nsites, B, T*d) u8; TD = T * d
int sk_emit_dropout_bits(unsigned long long seed, void* out, int num_layers,
                         int nsites, int B, int TD, void* stream) {
  if (nsites < 1 || nsites > 4 || B < 1 || B > 65535 || num_layers < 1 ||
      num_layers > 65535 || TD < 1)
    return (int)cudaErrorInvalidValue;
  const DropPrng p = make_prng(seed, 0, 0, 0);
  const dim3 grid((TD / 4 + kThreads) / kThreads, B, num_layers);
  emit_dropout_bits_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p.k0, p.k1, static_cast<uint8_t*>(out), nsites, B, TD);
  return (int)cudaGetLastError();
}

}  // extern "C"
