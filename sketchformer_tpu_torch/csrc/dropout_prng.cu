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
// What bounds it on the card: the bytes it writes, one per element and
// site, and, with one site, the Philox rounds as much: a call makes 16
// bytes of which one site keeps 4, so the integer multiplies of its ten
// rounds (two wide multiplies and two three-way XORs a round) take about
// as long to execute as the stores take to drain. The design keeps every
// instruction on that work:
// - a run of 16 positions a thread: four consecutive Philox calls, whose
//   byte k of each of the 16 words is packed with __byte_perm into one
//   16-byte store a site (ordinary stores: the consumer reads the bytes
//   right after, from L2);
// - a persistent grid sized from the SM count and the occupancy
//   (ops/dropout_prng.py::emit_plan) that walks the flattened (layer, b,
//   run) space by grid stride, the position advanced by additions alone
//   (the stride's quotients computed once on the host), so no block does a
//   few calls and retires;
// - the ten rounds' keys computed once on the host and read from the
//   kernel's parameters (__grid_constant__), not re-derived a call.
// A row whose length is not a multiple of 16, or an output not 16-byte
// aligned, takes the same runs with byte stores (the "bytes" route).
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <stdint.h>

#include "dropout_prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;  // positions a thread writes an item: four calls

struct EmitArgs {
  uint32_t k0[10], k1[10];  // each round's key: seed + round * Weyl step
  uint8_t* out;             // (num_layers * nsites, B, TD)
  int nsites, B, TD, layers;
  int runs;                 // 16-position runs a row: ceil(TD / 16)
  int dr, db, dl;           // the grid stride in (run, b, layer) steps
  int vec;                  // 16-byte stores (TD % 16 == 0, out aligned)
};

// Philox-4x32-10 with the rounds' keys given (philox4x32_10 of
// dropout_prng.cuh, bit for bit); each product one 64-bit multiply, so
// one wide multiply instruction gives both halves
__device__ __forceinline__ uint4 philox_keyed(uint4 c, const EmitArgs& a) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = 0xD2511F53ull * c.x;
    const unsigned long long p1 = 0xCD9E8D57ull * c.z;
    c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ a.k0[r], (uint32_t)p1,
                   (uint32_t)(p0 >> 32) ^ c.w ^ a.k1[r], (uint32_t)p0);
  }
  return c;
}

// byte k of each of the four words of one call, in order
__device__ __forceinline__ uint32_t pick_bytes(const uint4& w, uint32_t sel) {
  const uint32_t lo = __byte_perm(w.x, w.y, sel);
  const uint32_t hi = __byte_perm(w.z, w.w, sel);
  return __byte_perm(lo, hi, 0x5410);
}

__global__ void __launch_bounds__(kThreads)
emit_dropout_bits_kernel(const __grid_constant__ EmitArgs a) {
  // this thread's first item, then a grid stride at a time
  const int it = blockIdx.x * kThreads + threadIdx.x;
  int run = it % a.runs, b = it / a.runs;
  int layer = b / a.B;
  b -= layer * a.B;
  while (layer < a.layers) {
    const uint32_t stream = (uint32_t)layer * kLayerStride + (uint32_t)b;
    uint4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = philox_keyed(make_uint4(4u * run + j, stream, 0u, 0u), a);
    const int idx0 = kRun * run;
    for (int k = 0; k < a.nsites; ++k) {
      const uint32_t sel = (uint32_t)k | (uint32_t)(k + 4) << 4;
      const uint4 v = make_uint4(pick_bytes(w[0], sel), pick_bytes(w[1], sel),
                                 pick_bytes(w[2], sel), pick_bytes(w[3], sel));
      uint8_t* dst = a.out +
                     ((size_t)(layer * a.nsites + k) * a.B + b) * (size_t)a.TD +
                     idx0;
      if (a.vec) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < kRun; ++e)
          if (idx0 + e < a.TD) dst[e] = (uint8_t)(vw[e >> 2] >> (8 * (e & 3)));
      }
    }
    run += a.dr;
    b += a.db;
    layer += a.dl;
    if (run >= a.runs) {
      run -= a.runs;
      ++b;
    }
    if (b >= a.B) {
      b -= a.B;
      ++layer;
    }
  }
}

}  // namespace

extern "C" {

// out: (num_layers * nsites, B, T*d) u8; TD = T * d; grid: the plan's
// blocks (ops/dropout_prng.py::emit_plan), the items (num_layers * B *
// ceil(TD / 16)) below 2^31. Returns 0 or a CUDA error; route: 1 for the
// 16-byte stores, 0 for bytes.
int sk_emit_dropout_bits(unsigned long long seed, void* out, int num_layers,
                         int nsites, int B, int TD, int grid, int* route,
                         void* stream) {
  const long long runs = (TD + kRun - 1) / kRun;
  const long long items = runs * B * num_layers;
  if (nsites < 1 || nsites > 4 || B < 1 || num_layers < 1 || TD < 1 ||
      items >= (1ll << 31) || grid < 1 ||
      (long long)grid * kThreads >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  EmitArgs a;
  const DropPrng p = make_prng(seed, 0, 0, 0);
  for (int r = 0; r < 10; ++r) {
    a.k0[r] = p.k0 + (uint32_t)r * 0x9E3779B9u;
    a.k1[r] = p.k1 + (uint32_t)r * 0xBB67AE85u;
  }
  a.out = static_cast<uint8_t*>(out);
  a.nsites = nsites;
  a.B = B;
  a.TD = TD;
  a.layers = num_layers;
  a.runs = (int)runs;
  const long long stride = (long long)grid * kThreads;
  const long long rows = stride / runs;  // b steps of a stride
  a.dr = (int)(stride % runs);
  a.db = (int)(rows % B);
  a.dl = (int)(rows / B);
  a.vec = TD % kRun == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  *route = a.vec;
  emit_dropout_bits_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// the emit kernel's resident blocks an SM (its persistent grid's size)
int sk_emit_fit(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, emit_dropout_bits_kernel, kThreads, 0);
}

}  // extern "C"
