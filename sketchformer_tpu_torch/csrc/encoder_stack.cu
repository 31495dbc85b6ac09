// Hopper (sm_90a) kernels for the pre-LN encoder stack forward, and the
// products of the training stacks' forward and backward passes.
//
// Replaces the TPU kernel sketchformer_tpu/ops/pallas_encoder.py::
// fused_encoder_stack (body _stack_kernel), including the small-head
// attention and qk-norm it runs through sketchformer_tpu/ops/pallas_packed.py
// (group_attn_fwd, ln_blocks_fwd32) when head_dim < 128; and the products
// computed inside the training kernels' bodies,
// sketchformer_tpu/ops/pallas_encoder_train.py::_layer_bwd_kernel and
// sketchformer_tpu/ops/pallas_decoder_train.py::_dec_layer_bwd_kernel
// (linear_nt, linear_tn, and linear's dropout epilogue; see the note above
// linear_nt). A dropout site's bytes are read from a u8 tensor ('bits'
// mode) or drawn in-kernel from a Philox seed ('prng' mode, the port of
// sketchformer_tpu/ops/pallas_dropout.py::draw_layer_bytes; see
// dropout_prng.cuh and load_masked).
//
// The TPU kernel keeps a whole batch group's activations resident in VMEM
// for all L layers. That does not carry over: one sketch's (T=192, 3*256)
// bf16 QKV pane alone is 288 KB, above the 227 KB of shared memory a block
// can hold. So the stack runs as three kernels that the Python wrapper
// (ops/encoder_stack.py) launches layer by layer, each reading and writing
// its activations in device memory:
//
//   linear             a tiled product with f32 accumulation and an
//                      epilogue cast -> bias -> optional ReLU -> optional
//                      dropout -> optional residual add. Serves QKV, the
//                      out-projection (+x), FFN-in (+ReLU) and FFN-out (+x).
//   encoder_attention  (f32, and bf16 head widths that are not a multiple
//                      of 16) one block per (query tile, head, batch
//                      element); the full f32 score row of each query stays
//                      in shared memory (T <= 1024), so no online softmax is
//                      needed. bf16 at other widths runs the training
//                      stacks' tensor-core forward instead
//                      (attention_train.cu::attention_fwd_mma_kernel, the
//                      unnormalised exponentials rounded: the same
//                      numerics), chosen by ops/encoder_stack.py.
//   layernorm_rows     LN1 and LN2 ahead of QKV and FFN-in, and the final
//                      LayerNorm; a persistent grid whose warps hold rows
//                      in registers, f32 statistics (see its note).
//
// What bounds it on the card: at d_model=256 every product is small in K
// (256 or 512), so each layer moves its activations through device memory
// about seven times, and a product tile does little work per byte it loads.
// In bf16 linear, linear_tn and linear_nt run on wgmma with TMA and a ring
// of mbarrier stages (see their notes), f32 on the FMA units; the bf16
// attention runs on the tensor cores through mma.sync (attention_train.cu),
// the f32 one on the FMA units. LayerNorm is its own pass and not a
// prologue of the product: as a prologue, each of the N/64 column
// blocks of a row block recomputed the same row statistics and
// normalisation, which took as long again as the QKV product itself.
//
// Numerics follow _stack_kernel exactly: every product accumulates in f32,
// is rounded to the compute dtype, and only then has the (rounded) bias
// added; LayerNorm statistics are f32 with var = max(E[x^2] - mu^2, 0) and
// eps 1e-6; scores are f32, scaled, plus the f32 key-mask bias (0 / -1e9);
// the unnormalised exponentials are rounded to the compute dtype before the
// P.V product and the f32 sum divides the f32 result afterwards.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda.h>

#include <stdint.h>
#include <type_traits>

#include "common.cuh"
#include "dropout_prng.cuh"
#include "split_reduce.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// linear: out[M,N] = epilogue(a[M,K] @ w[K,N])
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64;
constexpr int kPadA = 8, kPadB = 8, kPadC = 4;  // padded shared-memory rows
constexpr int kLinBK = 32;  // K-slab depth of the f32 linear

// 16-byte vector of T; with kVec false it is filled element by element, so
// ragged K / N (not a multiple of the vector width) and unaligned operands
// take the same kernel body.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ base,
                                          size_t ld, int row, int col,
                                          int rows, int cols) {
  constexpr int VW = 16 / sizeof(T);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const T* p = base + (size_t)row * ld + col;
  if constexpr (kVec) {
    if (col < cols) v = *reinterpret_cast<const uint4*>(p);
  } else {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < VW; ++i)
      if (col + i < cols) e[i] = p[i];
  }
  return v;
}

// f32: 64 x 64 output tiles on the FMA units (16 x 16 threads, each a 4 x 4
// register tile strided by 16), 32-deep K slabs whose loads are in flight
// while the current slab is multiplied out of shared memory
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks per SM
linear_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual,
                  const uint8_t* __restrict__ drop, DropPrng prng, int thresh,
                  float keep_scale, float* __restrict__ out, int M, int N,
                  int K, int relu) {
  constexpr int BK = kLinBK, VW = 4;  // f32 elements per 16-byte vector
  constexpr int LDA = BK + kPadA, LDB = BN + kPadB, LDC = BN + kPadC;
  constexpr int kVecA = BM * BK / VW / kThreads;  // vectors per thread
  constexpr int kVecB = BK * BN / VW / kThreads;
  constexpr int kBytesAB = (BM * LDA + BK * LDB) * 4;
  constexpr int kBytesC = BM * LDC * 4;
  // the operand slabs and, after the main loop, the output tile
  __shared__ __align__(128)
      unsigned char smem[kBytesAB > kBytesC ? kBytesAB : kBytesC];
  float* as = reinterpret_cast<float*>(smem);  // [BM][LDA]
  float* bs = as + BM * LDA;                   // [BK][LDB]
  float* cs = reinterpret_cast<float*>(smem);  // [BM][LDC]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};
  uint4 ra[kVecA], rb[kVecB];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kVecA; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BK / VW), c = (v % (BK / VW)) * VW;
      ra[i] = load_vec<float, kVec>(a, K, m0 + r, k0 + c, M, K);
    }
#pragma unroll
    for (int i = 0; i < kVecB; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BN / VW), c = (v % (BN / VW)) * VW;
      rb[i] = load_vec<float, kVec>(w + n0, N, k0 + r, c, K, N - n0);
    }
  };
  auto store_slab = [&]() {
#pragma unroll
    for (int i = 0; i < kVecA; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BK / VW), c = (v % (BK / VW)) * VW;
      *reinterpret_cast<uint4*>(&as[r * LDA + c]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kVecB; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BN / VW), c = (v % (BN / VW)) * VW;
      *reinterpret_cast<uint4*>(&bs[r * LDB + c]) = rb[i];
    }
  };

  load_slab(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_slab();
    __syncthreads();
    if (k0 + BK < K) load_slab(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the slabs are dead: the output tile reuses their shared memory
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float v = cs[r * LDC + c] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      if (has_drop(drop, prng))  // u8-threshold dropout of the output
        v = drop_byte(drop, prng, m, n, N) >= (uint32_t)thresh
                ? v * keep_scale
                : 0.f;
      if (residual != nullptr) v = residual[(size_t)m * N + n] + v;
      out[(size_t)m * N + n] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// linear in bf16: out[M, N] = epilogue(a[M, K] . w[K, N]) on wgmma
// ---------------------------------------------------------------------------
//
// The serving stack's four products a layer and the training stacks'
// forward and recompute products (K = 256 or 512, N = 256-768; M = 12,288
// at sbir, 49,152 at the B = 512 training steps; the decoder's cross
// key-value product at M = B * Mq). The output is cut into 128 x 128 tiles,
// numbered row slab by row slab; the grid is persistent, two blocks an SM
// (or one a tile), block b taking tiles b, b + gridDim.x, ... Per tile, K
// streams in 64-deep slabs through a ring of `stages` mbarrier stages
// (the tiling, the stages and the grid are ops/encoder_stack.py::
// linear_plan's):
// thread 0 loads a's 128 rows (a 128 x 64 box, 128-byte swizzle: wgmma's
// K-major A operand) and w's 64 rows of the tile's 128 columns (two 64 x 64
// boxes: the MN-major B operand, the transpose in the descriptor) by TMA
// into each stage as soon as it is free, so no thread stages an operand,
// and the next tile's first slabs load while this one's epilogue runs.
// Warpgroups 0 and 1 run wgmma m64n128k16 on 64 rows each with the tile in
// 64 registers a thread, one slab's products in flight while the next
// slab's are issued. There is no producer warp: with two blocks of 8 warps
// an SM, each of its four schedulers holds 4 warps, so a thread may use 128
// registers (a ninth warp would cut that to 96 and spill the epilogue).
// Ahead of the products each warpgroup puts the tile's rounded bias in
// shared memory and its dropout bytes in registers (in 'prng' mode the four
// lanes of a quad, one row and 8 columns a block of the fragment, each run
// one Philox call for four columns and pass its bytes on by shuffle: one
// call for four elements, as mask8 draws). The epilogue runs from the
// accumulator: round to bf16, add the bias, round, ReLU, dropout (kept
// values times keep_scale, rounded), packed to bf16 pairs; then the four
// lanes of each quad trade pairs (a 4 x 4 transpose by shuffle) so that
// each lane holds 8 consecutive columns of a row, every residual load of
// the tile is issued at once, and each row's chunk is added and stored as
// one 16-byte vector. Each output element has one owner and one summation
// order: re-runs are bit-stable.
//
// What bounds it: bytes. At K = 256 the product does 2 K = 512 operations
// per output element it writes (2 bytes) and reads a once from device
// memory (N / 128 times from L2: the column tiles of a row slab run side by
// side), below the card's ~295 operations a byte. Three stages of 32 KB
// leave room for two blocks an SM (__launch_bounds__), so one block's
// epilogue also overlaps the other's products. At N = 256 a call runs at
// the rate of one PyTorch addmm; the wider calls (N = 512, 768) reach about
// two thirds of its rate (PERF.md), their output tiles written from
// registers.

constexpr int kLnRows = 128;     // output rows a block: two warpgroups of 64
constexpr int kLnCols = 128;     // output columns a block (n of the wgmma)
constexpr int kLnSlab = 64;      // contraction depth a stage
constexpr int kLnThreads = 256;  // two warpgroups; thread 0 issues the TMA
constexpr int kLnABox = kLnRows * 128;  // a's 128-row x 64-column bf16 box
constexpr int kLnWBox = kLnSlab * 128;  // one 64 x 64 box of w
constexpr int kLnStageBytes = kLnABox + 2 * kLnWBox;
// dynamic shared memory of a block with `stages` stages: the stages, 1024
// to align the swizzle atoms, the barriers and each consumer warpgroup's
// copy of two tiles' bias (f32)
constexpr size_t linear_smem_bytes(int stages) {
  return (size_t)stages * kLnStageBytes + 1024 +
         2 * stages * sizeof(uint64_t) + 4 * kLnCols * sizeof(float);
}

struct LinPlan {
  int col_tiles, row_tiles, slabs, stages, blocks, smem;
};

struct LinArgs {
  const float* bias;              // [N]
  const __nv_bfloat16* residual;  // [M][N] or null
  const uint8_t* drop;            // [M][N] mask bytes, or null
  DropPrng prng;
  int thresh;
  float keep_scale;
  __nv_bfloat16* out;             // [M][N]
  int M, N, relu;
  int vec16;  // N a multiple of 8, residual and out 16-byte aligned
};

// v[i] for a lane-dependent i, by selects (no local-memory indexing)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

template <bool kPrng>
__global__ void __launch_bounds__(kLnThreads, 2)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap, LinArgs a,
                    int slabs, int w_cols, int col_tiles, int tiles,
                    int stages) {
  extern __shared__ unsigned char ln_smem_raw[];
  // 1024-byte alignment: the swizzle atoms and the TMA boxes assume it
  unsigned char* smem = ln_smem_raw + ((1024u - (smem_u32(ln_smem_raw) &
                                                 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages *
                                               kLnStageBytes);
  uint64_t* empty = full + stages;
  // [tile parity][warpgroup][column]: each warpgroup's copy of a tile's
  // bias, two tiles deep
  float* sbias = reinterpret_cast<float*>(empty + stages);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kLnThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 loads: the block's slabs g = 0, 1, .. in turn (counted over
  // its tiles b, b + gridDim.x, ..), slab g into stage g % stages once both
  // warpgroups have released it; a tile whose second 64 columns lie past
  // w's last has one w box
  RingPos at_load;
  auto load = [&](int g) {
    const int k = g / slabs, i = g - k * slabs;
    const int tile = blockIdx.x + k * gridDim.x;
    if (tile >= tiles) return;
    const int s = at_load.s;
    mbar_wait(smem_u32(empty + s), at_load.phase ^ 1u);
    at_load.next(stages);
    const int m0 = tile / col_tiles * kLnRows;
    const int n0 = tile % col_tiles * kLnCols;
    const bool two = n0 + 64 < w_cols;
    unsigned char* st = smem + s * kLnStageBytes;
    const uint32_t bar = smem_u32(full + s);
    mbar_arrive_expect_tx(bar, kLnABox + (two ? 2 : 1) * kLnWBox);
    tma_load_2d(smem_u32(st), &amap, bar, i * kLnSlab, m0);
    tma_load_2d(smem_u32(st + kLnABox), &wmap, bar, n0, i * kLnSlab);
    if (two)
      tma_load_2d(smem_u32(st + kLnABox + kLnWBox), &wmap, bar, n0 + 64,
                  i * kLnSlab);
  };
  if (tid == 0)
    for (int g = 0; g < stages; ++g) load(g);

  // warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  const int warp = t >> 5, lane = t & 31, q = lane & 3;
  const bool bits = !kPrng && a.drop != nullptr;
  int g = 0, last = 0;  // slabs taken so far; the stage of the last
  RingPos at_take;
  for (int tile = blockIdx.x, par = 0; tile < tiles;
       tile += gridDim.x, par ^= 1) {
    const int m0 = tile / col_tiles * kLnRows;
    const int n0 = tile % col_tiles * kLnCols;
    // thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns
    // 8 j + 2 (l % 4) (+ 1) of the tile: acc[4 j + 2 r + e] is row + 8 r,
    // column + 8 j + e
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const int col = n0 + 2 * q;
    // ahead of the products, while the first slabs load: the tile's bias
    // rounded to bf16 into shared memory, and the dropout bytes of this
    // thread's columns e = 0, 1 of (j, r) into bits 16 r + 8 e of byt[j]
    float* sb = sbias + (2 * par + wg) * kLnCols;
    sb[t] = n0 + t < a.N ? round_dt<__nv_bfloat16>(a.bias[n0 + t]) : 0.f;
    uint32_t byt[16];
    if constexpr (kPrng) {
      // column blocks in pairs p (j = 2 p, 2 p + 1): a quad's four lanes
      // each draw one of the pair's four Philox calls (4 columns each), and
      // lane q's columns 8 j + 2 q (+ 1) are bytes 2 (q & 1) (+ 1) of the
      // call of lane 2 (j - 2 p) + q / 2
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        byt[2 * p] = byt[2 * p + 1] = 0u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint4 w4 = prng_words4(
              a.prng, row + 8 * r, n0 + 8 * (2 * p + (q >> 1)) + 4 * (q & 1),
              a.N);
          const uint32_t sh = a.prng.shift;
          const uint32_t mine = ((w4.x >> sh) & 255u) |
                                (((w4.y >> sh) & 255u) << 8) |
                                (((w4.z >> sh) & 255u) << 16) |
                                (((w4.w >> sh) & 255u) << 24);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            byt[2 * p + jj] |=
                ((__shfl_sync(0xffffffffu, mine,
                              (lane & ~3) | (2 * jj + (q >> 1))) >>
                  (16 * (q & 1))) & 0xffffu) << (16 * r);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        byt[j] = 0u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = row + 8 * r, n = col + 8 * j;
          if (bits && m < a.M && n < a.N) {
            const uint8_t* d = a.drop + (size_t)m * a.N + n;
            byt[j] |= (uint32_t)d[0] << (16 * r);
            if (n + 1 < a.N) byt[j] |= (uint32_t)d[1] << (16 * r + 8);
          }
        }
      }
    }
    // slab i's products are issued before slab i - 1's are waited for,
    // which then frees its stage for the slab `stages` on (the next
    // tile's first ones during this tile's last)
    float acc[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = 0.f;
    for (int i = 0; i < slabs; ++i, ++g) {
      const int s = at_take.s;
      mbar_wait(smem_u32(full + s), at_take.phase);
      at_take.next(stages);
      const uint32_t st = smem_u32(smem + s * kLnStageBytes);
      const uint32_t as = st + wg * 64 * 128, ws = st + kLnABox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kLnSlab / 16; ++kk)
        wgmma_m64n128_ss(acc, sw128_desc(as + kk * 32, 16),
                         sw128_desc(ws + kk * 2048, kLnWBox));
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();
        mbar_arrive(smem_u32(empty + last));
        if (tid == 0) load(g - 1 + stages);
      }
      last = s;
    }
    wgmma_wait<0>();
    mbar_arrive(smem_u32(empty + last));
    if (tid == 0) load(g - 1 + stages);
    // the warpgroup's bias is in place (named barrier 1 + wg, 128 threads)
    if (wg == 0)
      asm volatile("bar.sync 1, 128;" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;" ::: "memory");

    // the epilogue from the accumulator, while the next tile's first slabs
    // load: the value up to the dropout is formed and packed to bf16
    // (exact: each step rounds to bf16), which frees the accumulator
    uint32_t val[32];  // [2 j + r]: the bf16 pair of (j, r)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(sb + 8 * j + 2 * q);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[2] = {acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]};
        const float bv[2] = {bb.x, bb.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = round_dt<__nv_bfloat16>(round_dt<__nv_bfloat16>(v[e]) +
                                         bv[e]);
          if (a.relu) v[e] = fmaxf(v[e], 0.f);
          if (kPrng || bits)
            v[e] = ((byt[j] >> (16 * r + 8 * e)) & 255u) >= (uint32_t)a.thresh
                       ? v[e] * a.keep_scale
                       : 0.f;
        }
        val[2 * j + r] = pack_bf16(v[0], v[1]);
      }
    }
    // each quad transposes its 4 x 4 words (bf16 pairs) of column blocks
    // 4 G .. 4 G + 3, so that lane q holds block 4 G + q's 8 columns of each
    // of its rows (pk[2 G + r]): one 16-byte residual load and store each,
    // every residual load of the tile issued before any is used
    uint4 pk[8];
#pragma unroll
    for (int G = 0; G < 4; ++G)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t v[4] = {val[8 * G + r], val[8 * G + 2 + r],
                               val[8 * G + 4 + r], val[8 * G + 6 + r]};
        uint32_t o[4];  // o[k]: lane q ^ k's pair of block 4 G + q
        o[0] = pick4(v, q);
#pragma unroll
        for (int k = 1; k < 4; ++k)
          o[k] = __shfl_xor_sync(0xffffffffu, pick4(v, q ^ k), k);
        pk[2 * G + r] = make_uint4(pick4(o, q), pick4(o, q ^ 1),
                                   pick4(o, q ^ 2), pick4(o, q ^ 3));
      }
    if (a.residual != nullptr) {
      uint4 rs[8];
#pragma unroll
      for (int G = 0; G < 4; ++G)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = row + 8 * r, n = n0 + 8 * (4 * G + q);
          uint4 u = make_uint4(0u, 0u, 0u, 0u);
          if (m < a.M && n < a.N) {
            const __nv_bfloat16* src = a.residual + (size_t)m * a.N + n;
            if (a.vec16) {
              u = *reinterpret_cast<const uint4*>(src);
            } else {
              __nv_bfloat16* ue = reinterpret_cast<__nv_bfloat16*>(&u);
              for (int e = 0; e < min(8, a.N - n); ++e) ue[e] = src[e];
            }
          }
          rs[2 * G + r] = u;
        }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t* c = reinterpret_cast<uint32_t*>(&pk[i]);
        const uint32_t* y = reinterpret_cast<const uint32_t*>(&rs[i]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&c[w]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&y[w]));
          c[w] = pack_bf16(yf.x + xf.x, yf.y + xf.y);
        }
      }
    }
#pragma unroll
    for (int G = 0; G < 4; ++G)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row + 8 * r, n = n0 + 8 * (4 * G + q);
        if (m >= a.M || n >= a.N) continue;
        __nv_bfloat16* dst = a.out + (size_t)m * a.N + n;
        if (a.vec16) {
          *reinterpret_cast<uint4*>(dst) = pk[2 * G + r];
        } else {
          const __nv_bfloat16* ce =
              reinterpret_cast<const __nv_bfloat16*>(&pk[2 * G + r]);
          for (int e = 0; e < min(8, a.N - n); ++e) dst[e] = ce[e];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// linear_nt / linear_tn: the two products of a layer's backward pass
// ---------------------------------------------------------------------------
//
//   linear_nt  out[M, Ko] = a[M, K] . w[Ko, K]^T     (dX = dY . W^T)
//   linear_tn  out[Ko, N] = x[M, Ko]^T . y[M, N]     (dW = X^T . dY)
//
// The gradient operand (a for NT, y for TN) may be f32: it is multiplied by
// the dropout mask of its site (byte >= thresh -> keep_scale, else 0) in f32
// and rounded to the compute dtype as it is staged, which is where the TPU
// kernel rounds it (df.astype(dt)). linear_nt's epilogue optionally gates
// by a ReLU output (gate > 0, the FFN backward) and writes f32, or rounds to
// the compute dtype and adds a running sum (dmemory over the decoder's
// layers). In f32, linear_nt_f32_kernel stages each operand's tile as its rows
// arrive from device memory (load_masked) and runs the FMA inner loop of
// mma_slab; in bf16 it is linear_nt_wgmma_kernel (below). linear_tn
// reduces over all M rows in one launch, with the bias gradient beside it.

constexpr int TBK = 32;  // contraction slab of the f32 NT / TN products

// one TBK-deep slab on the FMA units: acc += A[BM][TBK] . B[TBK][BN], each
// thread a 4 x 4 register tile strided by 16. Each operand sits in shared
// memory as its global rows arrive, so the stores are contiguous: A as
// [BM][LDA] (kAT false) or [TBK][LDA] (kAT, A^T), B as [TBK][LDB] (kBT
// false) or [BN][LDB] (kBT, B^T).
template <bool kAT, int LDA, bool kBT, int LDB>
__device__ __forceinline__ void mma_slab(const float* as, const float* bs,
                                         float (&acc)[4][4], int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 8
  for (int kk = 0; kk < TBK; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      av[i] = kAT ? as[kk * LDA + r] : as[r * LDA + kk];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      bv[j] = kBT ? bs[c * LDB + kk] : bs[kk * LDB + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The gradient operand's kRows x kCols slab at (row0, col0) of an [.][N]
// f32 array, each element times its dropout mask, into kE registers a
// thread. 'bits' mode (kPrng false) reads the mask bytes from drop (or
// none) and gives thread tid the elements e = tid + i * kThreads (one
// column a lane); 'prng' mode draws them in-kernel and gives each thread
// four consecutive columns of a row per Philox call (N a multiple of 4), a
// quarter of the calls one element each would take. The two are separate
// instantiations, so the 'bits' kernels carry no Philox code in their main
// loop.
template <int kRows, int kCols, bool kPrng>
__device__ __forceinline__ void load_masked(
    float (&reg)[kRows * kCols / kThreads], const float* __restrict__ a,
    const uint8_t* __restrict__ drop, const DropPrng& prng, int row0,
    int col0, int row_lim, int N, int thresh, float keep_scale, int tid) {
  constexpr int kE = kRows * kCols / kThreads;
  if constexpr (!kPrng) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int e = tid + i * kThreads, r = e / kCols, c = e % kCols;
      const int m = row0 + r, n = col0 + c;
      float v = 0.f;
      if (m < row_lim && n < N) {
        v = a[(size_t)m * N + n];
        if (drop != nullptr)
          v *= drop[(size_t)m * N + n] >= (uint32_t)thresh ? keep_scale : 0.f;
      }
      reg[i] = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) {
      const int g = tid + i * kThreads, r = g / (kCols / 4);
      const int m = row0 + r, n = col0 + (g % (kCols / 4)) * 4;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (m < row_lim && n < N) w = prng_words4(prng, m, n, N);
      const uint32_t wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = 0.f;
        if (m < row_lim && n + j < N) {
          v = a[(size_t)m * N + n + j];
          v *= ((wj[j] >> prng.shift) & 255u) >= (uint32_t)thresh ? keep_scale
                                                                   : 0.f;
        }
        reg[4 * i + j] = v;
      }
    }
  }
}

// load_masked's registers into shared memory (row stride ld), same mapping
template <int kRows, int kCols, bool kPrng>
__device__ __forceinline__ void store_masked(
    const float (&reg)[kRows * kCols / kThreads], float* dst, int ld,
    int tid) {
  constexpr int kE = kRows * kCols / kThreads;
  if constexpr (!kPrng) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int e = tid + i * kThreads;
      dst[(e / kCols) * ld + e % kCols] = reg[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) {
      const int g = tid + i * kThreads;
      const int r = g / (kCols / 4), c = (g % (kCols / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[r * ld + c + j] = reg[4 * i + j];
    }
  }
}

constexpr int kLdaT = TBK + kPadA, kLdbT = BN + kPadB, kLdcT = BN + kPadC;
constexpr int kElemsA = BM * TBK / kThreads, kElemsB = TBK * BN / kThreads;
// NT: [BM][kLdaT] + [BN][kLdaT], then the [BM][kLdcT] output tile; TN:
// 2 x [TBK][kLdbT]
constexpr int kTrainSmem = 2 * BM * kLdaT > BM * kLdcT ? 2 * BM * kLdaT * 4
                                                       : BM * kLdcT * 4;

template <bool kPrng>
__global__ void __launch_bounds__(kThreads, 2)
linear_nt_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                     const uint8_t* __restrict__ drop, DropPrng prng,
                     int thresh, float keep_scale,
                     const float* __restrict__ gate,
                     const float* __restrict__ residual,
                     float* __restrict__ out, int M, int N, int K) {
  // a [M][N] (contraction N), w [K][N]; out [M][K]
  __shared__ __align__(128) unsigned char smem[kTrainSmem];
  float* as = reinterpret_cast<float*>(smem);  // [BM][kLdaT]: a rows
  float* bs = as + BM * kLdaT;                 // [BN][kLdaT]: w rows (B^T)
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  float acc[4][4] = {};
  float ra[kElemsA], rb[kElemsB];
  auto load_slab = [&](int n0) {
    load_masked<BM, TBK, kPrng>(ra, a, drop, prng, m0, n0, M, N, thresh,
                                keep_scale, tid);
#pragma unroll
    for (int i = 0; i < kElemsB; ++i) {
      const int e = tid + i * kThreads, c = e % TBK, r = e / TBK;
      const int k = k0 + r, n = n0 + c;
      rb[i] = k < K && n < N ? w[(size_t)k * N + n] : 0.f;
    }
  };
  load_slab(0);
  for (int n0 = 0; n0 < N; n0 += TBK) {
    store_masked<BM, TBK, kPrng>(ra, as, kLdaT, tid);
#pragma unroll
    for (int i = 0; i < kElemsB; ++i) {
      const int e = tid + i * kThreads;
      bs[(e / TBK) * kLdaT + e % TBK] = rb[i];
    }
    __syncthreads();
    if (n0 + TBK < N) load_slab(n0 + TBK);
    mma_slab<false, kLdaT, true, kLdaT>(as, bs, acc, tid);
    __syncthreads();
  }
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[(ty + 16 * i) * kLdcT + tx + 16 * j] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, k = k0 + c;
    if (m < M && k < K) {
      const size_t o = (size_t)m * K + k;
      float v = cs[r * kLdcT + c];
      if (gate != nullptr && !(gate[o] > 0.f)) v = 0.f;
      if (residual != nullptr) v += residual[o];
      out[o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// linear_tn: dW[K, N] = x[M, K]^T . (y[M, N] * mask) and db[N] = sum_m y * mask
// ---------------------------------------------------------------------------
//
// The reduction runs over all M rows, and (K, N) is small (256 x 768 is 12
// output tiles of 128 x 128), so M is cut into `splits` slices of
// rows_per_split rows (a multiple of kTnSlab) to fill the SMs. Every block
// writes its f32 partial tile to ws[tile][z]; the block that finishes a tile
// last adds the partials z = 0 .. S-1 in that fixed order and writes the
// result (split_reduce.cuh), so re-runs are bit-stable and no second launch
// follows. The bias gradient db
// is the f32 masked gradient summed before rounding (sum_rows_reference):
// the blocks of the first K tile add their rows' columns, and the last block
// of each of those tiles adds the partial rows in order too.
//
// bf16 (every main path): a warp-specialised block and a ring of kTnStages
// shared-memory stages on mbarriers. One producer warp issues TMA loads of
// a 64-row slab: x (two 64 x 64 boxes, 128-byte swizzle), the raw gradient
// rows (f32 or bf16) and, in 'bits' mode, their mask bytes. Warpgroup 2
// converts the slab in shared memory: times the mask (the bytes, or the
// in-kernel Philox draw of 'prng' mode, one prng_words4 per four columns),
// the f32 value added to its columns' db, rounded to bf16 into the MMA's
// swizzled layout. Warpgroups 0 and 1 each run wgmma m64n128k16 on 64 of
// the tile's 128 K rows; both operands are MN-major (the transposes are in
// the descriptors), so nothing is staged element by element, and no thread
// waits on a load from device memory.
// f32: the FMA body of mma_slab (64 x 64 tiles, 32-row slabs), with the same
// split reduction and db.

constexpr int kTnSlab = 64;     // contraction rows a stage (bf16) / split unit
constexpr int kTnTile = 128;    // bf16 output tile: 128 K rows x 128 columns
constexpr int kTnStages = 3;
constexpr int kTnThreads = 416;  // consumer WGs 0-1, converter WG 2, a TMA warp
constexpr int kTnBox = kTnSlab * 64 * 2;        // one 64 x 64 bf16 box, bytes
// a stage: x (2 boxes), the bf16 operand (2 blocks), the raw gradient rows
// (64 x 128 f32 at most), their mask bytes (64 x 128)
constexpr int kTnRaw = 4 * kTnBox, kTnBytes = 8 * kTnBox;
constexpr int kTnStageBytes = 9 * kTnBox;
// 128-byte swizzle atoms: 8 rows of 128 bytes; MN-major operand blocks of 64
// columns are kTnBox apart (LBO), 8-row groups 1024 bytes apart (SBO)
constexpr uint32_t kTnLbo = kTnBox, kTnSbo = 1024;

struct TnArgs {
  const void* y;          // [M][N] f32 or bf16
  const uint8_t* drop;    // [M][N] mask bytes, or null
  DropPrng prng;
  int thresh;
  float keep_scale;
  float* out;             // [K][N]
  float* db;              // [N] or null
  float* ws;              // [tiles][splits][tile] partials
  float* ws_db;           // [column tiles][splits][tile columns] partials
  unsigned* counters;     // [tiles], zero between launches
  int M, K, N, rows_per_split;
};

// v (8 columns n .. n + 7 of row m) times the dropout mask: 8 mask bytes
// ('bits'), or the in-kernel draw (one prng_words4 per four columns); a is
// linear_tn's or linear_nt's arguments (the mask's rows M and columns N)
template <bool kPrng, typename Args>
__device__ __forceinline__ void mask8(const Args& a, int m, int n,
                                      uint2 bytes, float (&v)[8]) {
  if constexpr (kPrng) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m >= a.M || n + 4 * h >= a.N) continue;
      const uint4 w = prng_words4(a.prng, m, n + 4 * h, a.N);
      const uint32_t wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * h + j] *= ((wj[j] >> a.prng.shift) & 255u) >= (uint32_t)a.thresh
                            ? a.keep_scale
                            : 0.f;
    }
  } else if (a.drop != nullptr) {
    const uint32_t wb[2] = {bytes.x, bytes.y};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] *= ((wb[j >> 2] >> (8 * (j & 3))) & 255u) >= (uint32_t)a.thresh
                  ? a.keep_scale
                  : 0.f;
  }
}

template <typename TB, bool kPrng>
__global__ void __launch_bounds__(kTnThreads, 1)
linear_tn_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap ymap,
                       const __grid_constant__ CUtensorMap dmap, TnArgs a) {
  extern __shared__ unsigned char tn_smem_raw[];
  // 1024-byte alignment: the swizzle atoms and the TMA boxes assume it
  unsigned char* smem = tn_smem_raw + ((1024u - (smem_u32(tn_smem_raw) &
                                                 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTnStages *
                                               kTnStageBytes);
  uint64_t* conv = full + kTnStages;
  uint64_t* empty = conv + kTnStages;
  int* flag = reinterpret_cast<int*>(empty + kTnStages);
  float* red = reinterpret_cast<float*>(smem + kTnBytes);  // [8][128], after

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int n0 = blockIdx.x * kTnTile, k0 = blockIdx.y * kTnTile;
  const int z = blockIdx.z, splits = gridDim.z;
  const int mb = z * a.rows_per_split;
  const int me = min(a.M, mb + a.rows_per_split);
  const int slabs = (me - mb + kTnSlab - 1) / kTnSlab;
  const bool with_db = a.db != nullptr && blockIdx.y == 0;
  const bool bits = !kPrng && a.drop != nullptr;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kTnStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(conv + s), 128);
      mbar_init(smem_u32(empty + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float dbp[8];  // a converter's db partial of its 8 columns
#pragma unroll
  for (int j = 0; j < 8; ++j) dbp[j] = 0.f;
  const int chunk = t & 15, rg = t >> 4;  // converter: 16B column chunk, rows

  if (wg == 3) {
    // the TMA warp: slab i into stage i % kTnStages once it is free
    if (t == 0) {
      const uint32_t tx = 2 * kTnBox + kTnSlab * kTnTile * sizeof(TB) +
                          (bits ? kTnSlab * kTnTile : 0);
      for (int i = 0; i < slabs; ++i) {
        const int s = i % kTnStages;
        mbar_wait(smem_u32(empty + s), ((i / kTnStages) & 1) ^ 1);
        unsigned char* st = smem + s * kTnStageBytes;
        const uint32_t bar = smem_u32(full + s);
        const int m0 = mb + i * kTnSlab;
        mbar_arrive_expect_tx(bar, tx);
        tma_load_2d(smem_u32(st), &xmap, bar, k0, m0);
        tma_load_2d(smem_u32(st + kTnBox), &xmap, bar, k0 + 64, m0);
        tma_load_2d(smem_u32(st + kTnRaw), &ymap, bar, n0, m0);
        if (bits) tma_load_2d(smem_u32(st + kTnBytes), &dmap, bar, n0, m0);
      }
    }
  } else if (wg == 2) {
    // converters: the raw rows of slab i, masked and rounded into the
    // operand's swizzled blocks
    for (int i = 0; i < slabs; ++i) {
      const int s = i % kTnStages;
      mbar_wait(smem_u32(full + s), (i / kTnStages) & 1);
      unsigned char* st = smem + s * kTnStageBytes;
      const TB* raw = reinterpret_cast<const TB*>(st + kTnRaw);
      const uint8_t* byt = st + kTnBytes;
      const int m0 = mb + i * kTnSlab, n = n0 + chunk * 8;
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int r = rg + 8 * rr;
        float v[8];
        if constexpr (std::is_same<TB, float>::value) {
          const float4 u = reinterpret_cast<const float4*>(
              raw + r * kTnTile + chunk * 8)[0];
          const float4 w = reinterpret_cast<const float4*>(
              raw + r * kTnTile + chunk * 8)[1];
          v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
          v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
        } else {
          const uint4 u = *reinterpret_cast<const uint4*>(
              raw + r * kTnTile + chunk * 8);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
        }
        const uint2 bw = bits ? *reinterpret_cast<const uint2*>(
                                    byt + r * kTnTile + chunk * 8)
                              : make_uint2(0u, 0u);
        mask8<kPrng>(a, m0 + r, n, bw, v);
        uint4 packed;
        __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dbp[2 * j] += v[2 * j];
          dbp[2 * j + 1] += v[2 * j + 1];
          p2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        }
        const int c = chunk & 7;
        *reinterpret_cast<uint4*>(st + 2 * kTnBox + (chunk >> 3) * kTnBox +
                                  r * 128 + ((c ^ (r & 7)) << 4)) = packed;
      }
      // the generic-proxy stores, visible to the tensor cores' async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(smem_u32(conv + s));
    }
  } else {
    // consumers: warpgroup wg owns K rows k0 + 64 wg .. + 63
    for (int i = 0; i < slabs; ++i) {
      const int s = i % kTnStages;
      mbar_wait(smem_u32(full + s), (i / kTnStages) & 1);
      mbar_wait(smem_u32(conv + s), (i / kTnStages) & 1);
      const uint32_t xs = smem_u32(smem + s * kTnStageBytes) + wg * kTnBox;
      const uint32_t ys = smem_u32(smem + s * kTnStageBytes) + 2 * kTnBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTnSlab / 16; ++kk)
        wgmma_m64n128_tt(acc, sw128_desc(xs + kk * 2 * kTnSbo, kTnLbo),
                         sw128_desc(ys + kk * 2 * kTnSbo, kTnLbo));
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(smem_u32(empty + s));
    }
  }
  __syncthreads();  // every stage consumed: red may reuse stage 0

  // this split's partial tile, in the accumulator's fragment order: thread
  // (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns 8 j +
  // 2 (l % 4) (+ 1)
  float* part = a.ws + ((size_t)tile * splits + z) * kTnTile * kTnTile;
  if (wg < 2) {
    const int warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int c = (i >> 2) * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(part + r * kTnTile + c) =
          make_float2(acc[i], acc[i + 1]);
    }
  } else if (wg == 2 && with_db) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[rg * kTnTile + chunk * 8 + j] = dbp[j];
  }
  __syncthreads();
  if (with_db && tid < kTnTile) {  // the 8 row groups in order
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) s += red[g * kTnTile + tid];
    a.ws_db[((size_t)blockIdx.x * splits + z) * kTnTile + tid] = s;
  }
  if (split_last_block(a.counters + tile, splits, flag))
    split_reduce<kTnTile, kTnTile>(
        a.ws + (size_t)tile * splits * kTnTile * kTnTile, splits, a.out, a.K,
        a.N, k0, n0,
        with_db ? a.ws_db + (size_t)blockIdx.x * splits * kTnTile : nullptr,
        a.db);
}

// f32: the 64 x 64 FMA tile of mma_slab over 32-row slabs
template <bool kPrng>
__global__ void __launch_bounds__(kThreads, 2)
linear_tn_f32_kernel(const float* __restrict__ x, TnArgs a) {
  __shared__ __align__(128) unsigned char smem[kTrainSmem];
  __shared__ int flag;
  float* as = reinterpret_cast<float*>(smem);  // [TBK][kLdbT]: x rows (A^T)
  float* bs = as + TBK * kLdbT;                // [TBK][kLdbT]: y rows
  const float* y = static_cast<const float*>(a.y);
  const int M = a.M, K = a.K, N = a.N;

  const int tid = threadIdx.x;
  const int kr0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int z = blockIdx.z, splits = gridDim.z;
  const int mb = z * a.rows_per_split;
  const int me = min(M, mb + a.rows_per_split);
  const bool with_db = a.db != nullptr && blockIdx.y == 0;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float acc[4][4] = {};
  float dbacc = 0.f;
  float ra[kElemsA], rb[kElemsB];
  auto load_slab = [&](int m0) {
#pragma unroll
    for (int i = 0; i < kElemsA; ++i) {
      const int e = tid + i * kThreads, r = e % BM, c = e / BM;
      const int m = m0 + c, k = kr0 + r;
      ra[i] = m < me && k < K ? x[(size_t)m * K + k] : 0.f;
    }
    load_masked<TBK, BN, kPrng>(rb, y, a.drop, a.prng, m0, n0, me, N,
                                a.thresh, a.keep_scale, tid);
  };
  load_slab(mb);
  for (int m0 = mb; m0 < me; m0 += TBK) {
#pragma unroll
    for (int i = 0; i < kElemsA; ++i) {
      const int e = tid + i * kThreads;
      as[(e / BM) * kLdbT + e % BM] = ra[i];
    }
    store_masked<TBK, BN, kPrng>(rb, bs, kLdbT, tid);
    __syncthreads();
    if (with_db && tid < BN)
      for (int r = 0; r < TBK; ++r) dbacc += bs[r * kLdbT + tid];
    if (m0 + TBK < me) load_slab(m0 + TBK);
    mma_slab<true, kLdbT, false, kLdbT>(as, bs, acc, tid);
    __syncthreads();
  }
  float* part = a.ws + ((size_t)tile * splits + z) * BM * BN;
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[(ty + 16 * i) * BN + tx + 16 * j] = acc[i][j];
  if (with_db && tid < BN)
    a.ws_db[((size_t)blockIdx.x * splits + z) * BN + tid] = dbacc;
  if (split_last_block(a.counters + tile, splits, &flag))
    split_reduce<BM, BN>(a.ws + (size_t)tile * splits * BM * BN, splits, a.out,
                      K, N, kr0, n0,
                      with_db ? a.ws_db + (size_t)blockIdx.x * splits * BN
                              : nullptr,
                      a.db);
}

// ---------------------------------------------------------------------------
// linear_nt in bf16: out[M, K] = (a[M, N] * mask) . w[K, N]^T on wgmma
// ---------------------------------------------------------------------------
//
// linear_tn's warp-specialised shape, for the input gradient. A block owns
// a 128 x 128 output tile (rows m0.., columns k0..) and walks the
// contraction N (256-768 on the stacks' paths, so no split-K) in 64-column
// slabs through a ring of kNtStages mbarrier stages. Per slab the TMA warp
// loads W's rows k0 .. k0 + 127 (128 x 64 bf16, 128-byte swizzle: wgmma's
// K-major B operand of a . w^T), the raw rows of a (128 x 64, f32 or bf16)
// and, in 'bits' mode, their mask bytes. Warpgroup 2 converts a in shared
// memory: times the mask (the bytes, or the in-kernel Philox draw of
// 'prng' mode, mask8) in f32, rounded to bf16 into the 128-byte-swizzled
// K-major A layout. Where a is bf16 and has no mask (kDirect), TMA lands it
// in that layout itself and the converter has nothing to do. Warpgroups 0
// and 1 run wgmma m64n128k16 on 64 rows each, both operands K-major; the
// tile stays in 64 registers a thread over all of N, and the epilogue (the
// gate > 0, the residual added after rounding to bf16, the f32 or bf16
// store) runs from those registers. Each output element has one owner and
// one summation order: re-runs are bit-stable.
//
// What bounds it: bytes. At K = 256 the product does 2 K operations per
// element of a it reads (f32: 4 bytes), far below the card's ~295
// operations a byte; each row slab of a is read once from device memory and
// K / 128 times from L2 (the column tiles of a row slab are neighbours in
// the grid). At M = 12,288 the grid is 96 x 2-4 tiles (1.5-3 waves of one
// block an SM), at M = 49,152 384 x 2-4 (5.8-11.6 waves). A block's
// epilogue does not overlap the next block's loads (one block an SM), so
// the calls with the largest outputs (the ReLU-gated one: f32 M x 512 and
// the gate) sit furthest above their bytes.

constexpr int kNtRows = 128;     // output rows a block: two warpgroups of 64
constexpr int kNtCols = 128;     // output columns a block (n of the wgmma)
constexpr int kNtSlab = 64;      // contraction columns a stage
constexpr int kNtStages = 3;
constexpr int kNtThreads = 416;  // consumer WGs 0-1, converter WG 2, a TMA warp
constexpr int kNtBox = kNtRows * 128;  // a 128-row x 64-column bf16 box
// a stage: the bf16 A slab, W's rows, the raw a rows (128 x 64 f32 at
// most), their mask bytes (128 x 64)
constexpr int kNtW = kNtBox, kNtRaw = 2 * kNtBox, kNtBytes = 4 * kNtBox;
constexpr int kNtStageBytes = 4 * kNtBox + kNtRows * kNtSlab;
constexpr size_t kNtSmem = kNtStages * kNtStageBytes + 1024 +
                           3 * kNtStages * sizeof(uint64_t);

struct NtArgs {
  const uint8_t* drop;    // [M][d_pitch] mask bytes, or null
  DropPrng prng;
  int thresh;
  float keep_scale;
  const __nv_bfloat16* gate;      // [M][K] or null
  const __nv_bfloat16* residual;  // [M][K] or null
  void* out;                      // [M][K] f32 or bf16
  int out_f32;
  int M, N, K;                    // N: a's columns (the mask's, prng's)
};

template <typename TA, bool kPrng, bool kDirect>
__global__ void __launch_bounds__(kNtThreads, 1)
linear_nt_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap dmap, NtArgs a,
                       int slabs) {
  extern __shared__ unsigned char nt_smem_raw[];
  unsigned char* smem = nt_smem_raw + ((1024u - (smem_u32(nt_smem_raw) &
                                                 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kNtStages *
                                               kNtStageBytes);
  uint64_t* conv = full + kNtStages;
  uint64_t* empty = conv + kNtStages;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int k0 = blockIdx.x * kNtCols, m0 = blockIdx.y * kNtRows;
  const bool bits = !kPrng && !kDirect && a.drop != nullptr;

  if (tid == 0) {
    for (int s = 0; s < kNtStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(conv + s), 128);
      mbar_init(smem_u32(empty + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 3) {
    // the TMA warp: slab i into stage i % kNtStages once it is free
    if (t == 0) {
      const uint32_t tx = kNtW + kNtRows * kNtSlab * (uint32_t)sizeof(TA) +
                          (bits ? kNtRows * kNtSlab : 0);
      for (int i = 0; i < slabs; ++i) {
        const int s = i % kNtStages;
        mbar_wait(smem_u32(empty + s), ((i / kNtStages) & 1) ^ 1);
        unsigned char* st = smem + s * kNtStageBytes;
        const uint32_t bar = smem_u32(full + s);
        mbar_arrive_expect_tx(bar, tx);
        tma_load_2d(smem_u32(st + kNtW), &wmap, bar, i * kNtSlab, k0);
        tma_load_2d(smem_u32(st + (kDirect ? 0 : kNtRaw)), &amap, bar,
                    i * kNtSlab, m0);
        if (bits)
          tma_load_2d(smem_u32(st + kNtBytes), &dmap, bar, i * kNtSlab, m0);
      }
    }
    return;
  }
  if (wg == 2) {
    if constexpr (!kDirect) {
      // converters: the raw rows of slab i, masked and rounded into the
      // swizzled A slab; thread t a 16-byte chunk of 8 columns of 8 rows
      const int chunk = t & 7, rg = t >> 3;
      for (int i = 0; i < slabs; ++i) {
        const int s = i % kNtStages;
        mbar_wait(smem_u32(full + s), (i / kNtStages) & 1);
        unsigned char* st = smem + s * kNtStageBytes;
        const TA* raw = reinterpret_cast<const TA*>(st + kNtRaw);
        const uint8_t* byt = st + kNtBytes;
        const int n = i * kNtSlab + chunk * 8;
#pragma unroll
        for (int rr = 0; rr < kNtRows / 16; ++rr) {
          const int r = rg + 16 * rr;
          float v[8];
          if constexpr (std::is_same<TA, float>::value) {
            const float4* p = reinterpret_cast<const float4*>(
                raw + r * kNtSlab + chunk * 8);
            const float4 u = p[0], w = p[1];
            v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
            v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
          } else {
            const uint4 u = *reinterpret_cast<const uint4*>(
                raw + r * kNtSlab + chunk * 8);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
          }
          const uint2 bw = bits ? *reinterpret_cast<const uint2*>(
                                      byt + r * kNtSlab + chunk * 8)
                                : make_uint2(0u, 0u);
          mask8<kPrng>(a, m0 + r, n, bw, v);
          uint4 packed;
          __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
          *reinterpret_cast<uint4*>(st + r * 128 +
                                    ((chunk ^ (r & 7)) << 4)) = packed;
        }
        // the generic-proxy stores, visible to the tensor cores' async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(smem_u32(conv + s));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < slabs; ++i) {
    const int s = i % kNtStages;
    mbar_wait(smem_u32(full + s), (i / kNtStages) & 1);
    if constexpr (!kDirect) mbar_wait(smem_u32(conv + s), (i / kNtStages) & 1);
    const uint32_t st = smem_u32(smem + s * kNtStageBytes);
    const uint32_t as = st + wg * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNtSlab / 16; ++kk)
      wgmma_m64n128_kk(acc, sw128_desc(as + kk * 32, 16),
                       sw128_desc(st + kNtW + kk * 32, 16));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(smem_u32(empty + s));
  }

  // the epilogue from the accumulator: thread (warp w, lane l) holds rows
  // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1). With K even (every
  // stack call) a thread's gate and residual pairs for 16 accumulator pairs
  // are loaded together before any is used, so their latencies overlap
  const int warp = t >> 5, lane = t & 31;
  const int mrow = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int kcol = k0 + (lane & 3) * 2;
  if (a.K % 2 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 gv[16], rv[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = 32 * h + 2 * q;
        const int m = mrow + 8 * ((i >> 1) & 1), k = kcol + (i >> 2) * 8;
        const bool ok = m < a.M && k < a.K;
        const size_t o = (size_t)m * a.K + k;
        gv[q] = rv[q] = __floats2bfloat162_rn(0.f, 0.f);
        if (ok && a.gate != nullptr)
          gv[q] = *reinterpret_cast<const __nv_bfloat162*>(a.gate + o);
        if (ok && a.residual != nullptr)
          rv[q] = *reinterpret_cast<const __nv_bfloat162*>(a.residual + o);
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = 32 * h + 2 * q;
        const int m = mrow + 8 * ((i >> 1) & 1), k = kcol + (i >> 2) * 8;
        if (m >= a.M || k >= a.K) continue;
        const size_t o = (size_t)m * a.K + k;
        float v0 = acc[i], v1 = acc[i + 1];
        if (a.gate != nullptr) {
          if (!(__low2float(gv[q]) > 0.f)) v0 = 0.f;
          if (!(__high2float(gv[q]) > 0.f)) v1 = 0.f;
        }
        if (a.residual != nullptr) {
          v0 = __low2float(rv[q]) + __bfloat162float(__float2bfloat16(v0));
          v1 = __high2float(rv[q]) + __bfloat162float(__float2bfloat16(v1));
        }
        if (a.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + o) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
    return;
  }
  // odd K: element by element
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int m = mrow + 8 * ((i >> 1) & 1), k = kcol + (i >> 2) * 8 + (i & 1);
    if (m >= a.M || k >= a.K) continue;
    const size_t o = (size_t)m * a.K + k;
    float v = acc[i];
    if (a.gate != nullptr && !(__bfloat162float(a.gate[o]) > 0.f)) v = 0.f;
    if (a.residual != nullptr)
      v = __bfloat162float(a.residual[o]) +
          __bfloat162float(__float2bfloat16(v));
    if (a.out_f32)
      static_cast<float*>(a.out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------------------
// encoder_attention: out[b, t, h*Dh:(h+1)*Dh] over a (B, T, 3*H*Dh) qkv pane
// (f32, and the bf16 head widths the tensor-core forward does not take)
// ---------------------------------------------------------------------------

constexpr int kRowsPerWarp = 4;
constexpr int kQT = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKC = 64;                     // keys staged per chunk

// One head row (Dh <= 32*NI values) into registers, lane-strided; with
// norm_s != nullptr, the per-head LayerNorm (qk-norm) in f32, rounded to
// the compute dtype as the TPU kernel's _ln does.
template <typename T, int NI>
__device__ __forceinline__ void load_head_row(const T* __restrict__ p, int Dh,
                                              int lane,
                                              const float* __restrict__ norm_s,
                                              const float* __restrict__ norm_b,
                                              float (&v)[NI]) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < Dh ? to_f<T>(p[d]) : 0.f;
    s += v[i];
    ss += v[i] * v[i];
  }
  if (norm_s != nullptr) {
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / Dh;
    const float rstd = 1.f / sqrtf(fmaxf(ss / Dh - mu * mu, 0.f) + kLnEps);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) v[i] = round_dt<T>((v[i] - mu) * rstd * norm_s[d] + norm_b[d]);
    }
  }
}

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ key_bias,
                         const float* __restrict__ qn_s,
                         const float* __restrict__ qn_b,
                         const float* __restrict__ kn_s,
                         const float* __restrict__ kn_b, T* __restrict__ out,
                         int Tn, int H, int Dh, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [kQT][Dh]   normed queries
  float* sc = qs + kQT * Dh;     // [kQT][Tn]   scores, then rounded exp
  float* kv = sc + kQT * Tn;     // [kKC][Dh+1] staged keys or values

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * Dh;
  const size_t row_stride = 3 * (size_t)HD;
  const T* base = qkv + (size_t)b * Tn * row_stride;
  const float* kb = key_bias != nullptr ? key_bias + (size_t)b * Tn : nullptr;
  const int kvs = Dh + 1;  // odd stride: lanes on different keys miss banks

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int t = min(t0 + r, Tn - 1);  // ragged tile: computed, not stored
    float v[NI];
    load_head_row<T, NI>(base + (size_t)t * row_stride + h * Dh, Dh, lane,
                         qn_s, qn_b, v);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) qs[r * Dh + d] = v[i];
    }
  }
  __syncwarp();

  // scores s = (q . k) * scale + key_bias, in f32
  for (int c0 = 0; c0 < Tn; c0 += kKC) {
    const int nk = min(kKC, Tn - c0);
    __syncthreads();
    for (int j = warp; j < nk; j += kWarps) {
      float v[NI];
      load_head_row<T, NI>(base + (size_t)(c0 + j) * row_stride + HD + h * Dh,
                           Dh, lane, kn_s, kn_b, v);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) kv[j * kvs + d] = v[i];
      }
    }
    __syncthreads();
    float acc[kRowsPerWarp][kKC / 32];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) acc[rr][u] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float kval[kKC / 32];
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) {
        const int j = lane + 32 * u;
        kval[u] = j < nk ? kv[j * kvs + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float qv = qs[(warp * kRowsPerWarp + rr) * Dh + d];
#pragma unroll
        for (int u = 0; u < kKC / 32; ++u)
          acc[rr][u] = fmaf(qv, kval[u], acc[rr][u]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float* row = sc + (warp * kRowsPerWarp + rr) * Tn;
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < nk) {
          float s = acc[rr][u] * scale;
          if (kb != nullptr) s += kb[c0 + j];
          row[c0 + j] = s;
        }
      }
    }
  }
  __syncwarp();

  // softmax numerators: e = exp(s - max), f32 sum; e is stored rounded to
  // the compute dtype for the P.V product
  float denom[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    float* row = sc + (warp * kRowsPerWarp + rr) * Tn;
    float m = -INFINITY;
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(row[j] - m);
      sum += e;
      row[j] = round_dt<T>(e);
    }
    denom[rr] = warp_sum(sum);
  }
  __syncwarp();

  // o = e @ v in f32, then / denom
  float o[kRowsPerWarp][NI];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < NI; ++i) o[rr][i] = 0.f;
  for (int c0 = 0; c0 < Tn; c0 += kKC) {
    const int nk = min(kKC, Tn - c0);
    __syncthreads();
    for (int j = warp; j < nk; j += kWarps) {
      const T* p = base + (size_t)(c0 + j) * row_stride + 2 * HD + h * Dh;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) kv[j * kvs + d] = to_f<T>(p[d]);
      }
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < Dh ? kv[j * kvs + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = sc[(warp * kRowsPerWarp + rr) * Tn + c0 + j];
#pragma unroll
        for (int i = 0; i < NI; ++i) o[rr][i] = fmaf(p, vv[i], o[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp * kRowsPerWarp + rr;
    if (t < Tn) {
      T* dst = out + ((size_t)b * Tn + t) * HD + h * Dh;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) dst[d] = from_f<T>(o[rr][i] / denom[rr]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// layernorm_rows: y = LN(x) over the last axis
// ---------------------------------------------------------------------------
//
// Replaces _ln of sketchformer_tpu/ops/pallas_encoder.py (fused_encoder_stack
// and the train stacks' kernels). Bound by bytes: x read once, y written
// once (D=256 bf16: 1 KB a row), a few operations an element. Two kernels:
//
//   layernorm_rows_warp_kernel  the plan of ops/encoder_stack.py::
//     layernorm_rows_plan: a persistent grid of 8-warp blocks, four an SM
//     (two at C = 2), whose warps walk groups of rows with a grid stride.
//     A row is held by `lanes` lanes (a power of two up to 32, so a warp
//     holds 32 / lanes rows at once), each lane holding C 16-byte vectors
//     of it (vectors lane, lane + lanes, ..; D = 256 bf16 is one vector a
//     lane) from its one read, and its columns of scale and bias in
//     registers, loaded once a warp. The next group's loads are issued
//     before the current group is reduced (xor shuffles over its lanes),
//     so each warp keeps two groups in flight; the output leaves in
//     16-byte stores. (A ring of three groups a warp spilled at 64
//     registers and ran slower.)
//   layernorm_rows_kernel  the geometries the plan declines (a D that is
//     not whole 16-byte vectors, a misaligned base, a D past the registers:
//     more than 2 x 32 vectors): one warp per row, eight rows a block, the
//     row read twice and the parameters once an element.
//
// Both keep _ln's statistics: f32 sum and sum of squares in one pass, var =
// max(E[x^2] - mu^2, 0), 1 / sqrt(var + eps), one rounding to x's dtype.

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
layernorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ bvec, T* __restrict__ y, int M,
                      int D) {
  constexpr int VW = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= M) return;
  float sum = 0.f, ss = 0.f;
  for (int k = lane * VW; k < D; k += 32 * VW) {
    uint4 v = load_vec<T, kVec>(x, D, m, k, M, D);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const float f = to_f<T>(e[i]);
      sum += f;
      ss += f * f;
    }
  }
  sum = warp_sum(sum);
  ss = warp_sum(ss);
  const float mu = sum / D;
  const float rstd = 1.f / sqrtf(fmaxf(ss / D - mu * mu, 0.f) + kLnEps);
  for (int k = lane * VW; k < D; k += 32 * VW) {
    uint4 v = load_vec<T, kVec>(x, D, m, k, M, D);
    const T* e = reinterpret_cast<const T*>(&v);
    T* dst = y + (size_t)m * D + k;
    if constexpr (kVec) {
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < VW; ++i)
        oe[i] = from_f<T>((to_f<T>(e[i]) - mu) * rstd * s[k + i] + bvec[k + i]);
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
#pragma unroll
      for (int i = 0; i < VW; ++i)
        if (k + i < D)
          dst[i] = from_f<T>((to_f<T>(e[i]) - mu) * rstd * s[k + i] + bvec[k + i]);
    }
  }
}

// resident blocks an SM by C, the registers' share of a thread
// (ops/encoder_stack.py LN_ROWS_BLOCKS_PER_SM): 64 registers at C = 1,
// 128 at C = 2 (its scale, bias and two groups in flight spill in 64)
__host__ __device__ constexpr int ln_rows_blocks_per_sm(int C) {
  return C == 1 ? 4 : 2;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, ln_rows_blocks_per_sm(C))
layernorm_rows_warp_kernel(const T* __restrict__ x,
                           const float* __restrict__ s,
                           const float* __restrict__ bvec, T* __restrict__ y,
                           int M, int D, int lanes) {
  constexpr int VW = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / lanes, li = lane & (lanes - 1);
  const int per_warp = 32 / lanes, nvec = D / VW;
  const int groups = (M + per_warp - 1) / per_warp;
  float sc[C][VW], bi[C][VW];
  bool has[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int v = li + c * lanes;
    has[c] = v < nvec;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      sc[c][i] = has[c] ? s[v * VW + i] : 0.f;
      bi[c][i] = has[c] ? bvec[v * VW + i] : 0.f;
    }
  }
  auto load = [&](int g, uint4 (&u)[C]) {
    const int m = g * per_warp + sub;
#pragma unroll
    for (int c = 0; c < C; ++c)
      u[c] = has[c] && m < M
                 ? *reinterpret_cast<const uint4*>(
                       x + (size_t)m * D + (li + c * lanes) * VW)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  const int stride = gridDim.x * kWarps;
  int g = blockIdx.x * kWarps + warp;
  uint4 cur[C], nxt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) nxt[c] = make_uint4(0u, 0u, 0u, 0u);
  if (g < groups) load(g, cur);
  for (; g < groups; g += stride) {
    if (g + stride < groups) load(g + stride, nxt);  // in flight meanwhile
    float sum = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T* e = reinterpret_cast<const T*>(&cur[c]);
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        const float f = to_f<T>(e[i]);
        sum += f;
        ss += f * f;
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {  // a row's lanes, xor tree
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = sum / D;
    const float rstd = 1.f / sqrtf(fmaxf(ss / D - mu * mu, 0.f) + kLnEps);
    const int m = g * per_warp + sub;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (has[c] && m < M) {
        const T* e = reinterpret_cast<const T*>(&cur[c]);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int i = 0; i < VW; ++i)
          oe[i] = from_f<T>((to_f<T>(e[i]) - mu) * rstd * sc[c][i] +
                            bi[c][i]);
        *reinterpret_cast<uint4*>(y + (size_t)m * D +
                                  (li + c * lanes) * VW) = o;
      }
      cur[c] = nxt[c];
    }
  }
}

template <typename T>
bool vector_ok(const void* p, int cols) {
  return cols % (16 / (int)sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// f32: the FMA tile kernel
int launch_linear_f32(const void* a, const void* w, const void* bias,
                      const void* residual, const void* drop, DropPrng prng,
                      int thresh, float keep_scale, void* out, int M, int N,
                      int K, int relu, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = vector_ok<float>(a, K) && vector_ok<float>(w, N);
  auto kernel = vec ? linear_f32_kernel<true> : linear_f32_kernel<false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<const uint8_t*>(drop), prng, thresh, keep_scale,
      static_cast<float*>(out), M, N, K, relu);
  return (int)cudaGetLastError();
}

// bf16: a (M, a_pitch) and w (K, w_pitch), their columns past K and N
// zero, pitches whole 16-byte rows and bases 16-byte aligned; the plan of
// ops/encoder_stack.py::linear_plan: col_tiles x row_tiles 128 x 128 tiles,
// K in `slabs` 64-deep slabs through `stages` stages, at most `blocks`
// persistent blocks (two an SM) of `smem` bytes, each walking its share of
// the tiles
template <bool kPrng>
int launch_linear_bf16(const void* a, const void* w, int a_pitch,
                       int w_pitch, int K, const LinPlan& plan,
                       const LinArgs& args, cudaStream_t stream) {
  auto misaligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n != 0;
  };
  if (a_pitch < K || a_pitch % 8 != 0 || w_pitch < args.N ||
      w_pitch % 8 != 0 || misaligned(a, 16) || misaligned(w, 16) ||
      (long long)plan.col_tiles * kLnCols < args.N ||
      (long long)plan.row_tiles * kLnRows < args.M ||
      (long long)plan.slabs * kLnSlab < K || plan.stages < 2 ||
      plan.blocks < 1 || plan.smem > 232448 ||
      (size_t)plan.smem < linear_smem_bytes(plan.stages))
    return (int)cudaErrorInvalidValue;
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap amap, wmap;
  if (!tmap_2d(&amap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, args.M,
               a_pitch, kLnSlab, kLnRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_2d(&wmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K,
               w_pitch, 64, kLnSlab, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static int attr_smem = 0;  // the largest size opted into so far
  if (plan.smem > attr_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        linear_wgmma_kernel<kPrng>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err == cudaSuccess)  // the largest carveout: two blocks an SM
      err = cudaFuncSetAttribute(linear_wgmma_kernel<kPrng>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attr_smem = plan.smem;
  }
  LinArgs la = args;
  la.vec16 = args.N % 8 == 0 && !misaligned(args.out, 16) &&
             (args.residual == nullptr || !misaligned(args.residual, 16));
  const int tiles = plan.col_tiles * plan.row_tiles;
  linear_wgmma_kernel<kPrng><<<tiles < plan.blocks ? tiles : plan.blocks,
                               kLnThreads, plan.smem, stream>>>(
      amap, wmap, la, plan.slabs, w_pitch, plan.col_tiles, tiles,
      plan.stages);
  return (int)cudaGetLastError();
}

// the plan of ops/encoder_stack.py::layernorm_rows_plan: `vecs` 0 is a
// declined geometry (the one-warp-a-row kernel); else `blocks` persistent
// blocks of `warps` warps, `lanes` lanes a row and `vecs` vectors a lane,
// refused (invalid value) unless it covers a row of whole 16-byte vectors
// from 16-byte aligned rows
template <typename T>
int launch_layernorm_rows(const void* x, const void* scale, const void* bias,
                          void* y, int M, int D, int blocks, int warps,
                          int lanes, int vecs, cudaStream_t stream) {
  if (vecs == 0) {
    const dim3 grid((M + kWarps - 1) / kWarps);
    const bool vec = vector_ok<T>(x, D) && vector_ok<T>(y, D);
    auto kernel =
        vec ? layernorm_rows_kernel<T, true> : layernorm_rows_kernel<T, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), M, D);
    return (int)cudaGetLastError();
  }
  constexpr int VW = 16 / sizeof(T);
  if (!vector_ok<T>(x, D) || !vector_ok<T>(y, D) || warps != kWarps ||
      blocks < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      vecs > 2 || lanes * vecs < D / VW)
    return (int)cudaErrorInvalidValue;
  auto kernel = vecs == 1 ? layernorm_rows_warp_kernel<T, 1>
                          : layernorm_rows_warp_kernel<T, 2>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), M, D, lanes);
  return (int)cudaGetLastError();
}

template <typename T, int NI>
int launch_attention(const void* qkv, const void* key_bias, const void* qn_s,
                     const void* qn_b, const void* kn_s, const void* kn_b,
                     void* out, int B, int Tn, int H, int Dh, float scale,
                     cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kQT * Dh + (size_t)kQT * Tn + (size_t)kKC * (Dh + 1));
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_kernel<T, NI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tn + kQT - 1) / kQT, H, B);
  encoder_attention_kernel<T, NI><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(key_bias),
      static_cast<const float*>(qn_s), static_cast<const float*>(qn_b),
      static_cast<const float*>(kn_s), static_cast<const float*>(kn_b),
      static_cast<T*>(out), Tn, H, Dh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attention_dh(const void* qkv, const void* key_bias,
                        const void* qn_s, const void* qn_b, const void* kn_s,
                        const void* kn_b, void* out, int B, int Tn, int H,
                        int Dh, float scale, cudaStream_t stream) {
  if (Dh <= 32)
    return launch_attention<T, 1>(qkv, key_bias, qn_s, qn_b, kn_s, kn_b, out,
                                  B, Tn, H, Dh, scale, stream);
  if (Dh <= 64)
    return launch_attention<T, 2>(qkv, key_bias, qn_s, qn_b, kn_s, kn_b, out,
                                  B, Tn, H, Dh, scale, stream);
  if (Dh <= 128)
    return launch_attention<T, 4>(qkv, key_bias, qn_s, qn_b, kn_s, kn_b, out,
                                  B, Tn, H, Dh, scale, stream);
  return (int)cudaErrorInvalidValue;
}


// f32: the WMMA/FMA tile kernel
template <bool kPrng>
int launch_linear_nt_f32(int a_f32, const void* a, const void* w,
                         const void* drop, DropPrng prng, int thresh,
                         float keep_scale, const void* gate,
                         const void* residual, int out_f32, void* out, int M,
                         int N, int K, cudaStream_t stream) {
  if (!a_f32 || !out_f32) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM);
  linear_nt_f32_kernel<kPrng><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const uint8_t*>(drop), prng, thresh, keep_scale,
      static_cast<const float*>(gate), static_cast<const float*>(residual),
      static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// bf16: a (M, pitch) f32 or bf16 and w (K, pitch) bf16, their columns past N
// zero; the mask bytes (M, d_pitch); pitches and bases 16-byte aligned
template <typename TA, bool kPrng, bool kDirect>
int launch_linear_nt_bf16(const void* a, const void* w, int pitch,
                          int d_pitch, const NtArgs& args,
                          cudaStream_t stream) {
  const int ae = (int)sizeof(TA);
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (pitch < args.N || pitch % 8 != 0 || misaligned(a) || misaligned(w) ||
      (args.drop != nullptr && (d_pitch % 16 != 0 || d_pitch < args.N ||
                                misaligned(args.drop))))
    return (int)cudaErrorInvalidValue;
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap amap, wmap, dmap;
  const CUtensorMapDataType at = ae == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tmap_2d(&wmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, args.K,
               pitch, kNtSlab, kNtCols, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_2d(&amap, encode, at, ae, a, args.M, pitch, kNtSlab, kNtRows,
               kDirect ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  dmap = wmap;  // unused without mask bytes
  if (!kPrng && !kDirect && args.drop != nullptr &&
      !tmap_2d(&dmap, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, args.drop,
               args.M, d_pitch, kNtSlab, kNtRows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // one instantiation, one attribute
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_nt_wgmma_kernel<TA, kPrng, kDirect>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kNtSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((args.K + kNtCols - 1) / kNtCols,
                  (args.M + kNtRows - 1) / kNtRows);
  linear_nt_wgmma_kernel<TA, kPrng, kDirect>
      <<<grid, kNtThreads, kNtSmem, stream>>>(amap, wmap, dmap, args,
                                               (pitch + kNtSlab - 1) / kNtSlab);
  return (int)cudaGetLastError();
}

constexpr size_t kTnSmem = kTnStages * kTnStageBytes + 1024 +
                           3 * kTnStages * sizeof(uint64_t) + 16;

// x (M, K) bf16; y (M, y_pitch) and the mask bytes (M, d_pitch), their
// columns past N zero; pitches and bases 16-byte aligned
template <typename TB, bool kPrng>
int launch_linear_tn_bf16(const void* x, int y_pitch, int d_pitch,
                          const TnArgs& a, int splits, cudaStream_t stream) {
  const int ye = (int)sizeof(TB);
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (a.K % 8 != 0 || (y_pitch * ye) % 16 != 0 || y_pitch < a.N ||
      misaligned(x) || misaligned(a.y) ||
      (a.drop != nullptr && (d_pitch % 16 != 0 || d_pitch < a.N ||
                             misaligned(a.drop))))
    return (int)cudaErrorInvalidValue;
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, ymap, dmap;
  const CUtensorMapDataType yt = ye == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tmap_2d(&xmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, a.M,
               a.K, 64, kTnSlab, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_2d(&ymap, encode, yt, ye, a.y, a.M, y_pitch, kTnTile, kTnSlab,
               CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  dmap = xmap;  // unused without mask bytes
  if (!kPrng && a.drop != nullptr &&
      !tmap_2d(&dmap, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.drop, a.M,
               d_pitch, kTnTile, kTnSlab, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // one instantiation, one attribute
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_tn_wgmma_kernel<TB, kPrng>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTnSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.N + kTnTile - 1) / kTnTile, (a.K + kTnTile - 1) / kTnTile,
                  splits);
  linear_tn_wgmma_kernel<TB, kPrng>
      <<<grid, kTnThreads, kTnSmem, stream>>>(xmap, ymap, dmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" {

// the dropout operand of sk_linear, sk_linear_nt and sk_linear_tn: the u8
// bytes in drop, or (drop null, prng_T > 0) site `site` of layer `layer`
// drawn in-kernel from seed, rows m = b * prng_T + t (dropout_prng.cuh; N a
// multiple of 4). bf16: a and w are read with row pitches a_pitch >= K and
// w_pitch >= N (16-byte rows, zero past K and N), on the plan of
// ops/encoder_stack.py::linear_plan (column tiles, row tiles, K slabs,
// stages, blocks, shared-memory bytes); f32: the pitches are K and N and
// the plan is unused
int sk_linear(int dtype, const void* a, const void* w, const void* bias,
              const void* residual, const void* drop, unsigned long long seed,
              int layer, int site, int prng_T, int thresh, float keep_scale,
              void* out, int M, int N, int K, int a_pitch, int w_pitch,
              int col_tiles, int row_tiles, int slabs, int stages,
              int blocks, int smem, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropPrng p = make_prng(seed, layer, site, prng_T);
  if (M < 1 || N < 1 || K < 1 || (prng_T > 0 && N % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_linear_f32(a, w, bias, residual, drop, p, thresh,
                             keep_scale, out, M, N, K, relu, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  LinArgs args;
  args.bias = static_cast<const float*>(bias);
  args.residual = static_cast<const __nv_bfloat16*>(residual);
  args.drop = static_cast<const uint8_t*>(drop);
  args.prng = p;
  args.thresh = thresh;
  args.keep_scale = keep_scale;
  args.out = static_cast<__nv_bfloat16*>(out);
  args.M = M; args.N = N; args.relu = relu;
  args.vec16 = 0;
  const LinPlan plan = {col_tiles, row_tiles, slabs, stages, blocks, smem};
  if (prng_T > 0)
    return launch_linear_bf16<true>(a, w, a_pitch, w_pitch, K, plan, args,
                                    s);
  return launch_linear_bf16<false>(a, w, a_pitch, w_pitch, K, plan, args,
                                   s);
}

// bf16: a and w are read with row pitch `pitch` >= N (16-byte rows, zero
// past N), the mask bytes with d_pitch; f32: both pitches are N
int sk_linear_nt(int dtype, int a_f32, const void* a, const void* w,
                 int pitch, const void* drop, int d_pitch,
                 unsigned long long seed, int layer, int site, int prng_T,
                 int thresh, float keep_scale, const void* gate,
                 const void* residual, int out_f32, void* out, int M, int N,
                 int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropPrng p = make_prng(seed, layer, site, prng_T);
  if (prng_T > 0 && N % 4 != 0) return (int)cudaErrorInvalidValue;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (prng_T > 0)
      return launch_linear_nt_f32<true>(a_f32, a, w, drop, p, thresh,
                                        keep_scale, gate, residual, out_f32,
                                        out, M, N, K, s);
    return launch_linear_nt_f32<false>(a_f32, a, w, drop, p, thresh,
                                       keep_scale, gate, residual, out_f32,
                                       out, M, N, K, s);
  }
  if (dtype != 1 || (residual != nullptr && out_f32))
    return (int)cudaErrorInvalidValue;
  NtArgs args;
  args.drop = static_cast<const uint8_t*>(drop);
  args.prng = p;
  args.thresh = thresh;
  args.keep_scale = keep_scale;
  args.gate = static_cast<const __nv_bfloat16*>(gate);
  args.residual = static_cast<const __nv_bfloat16*>(residual);
  args.out = out;
  args.out_f32 = out_f32;
  args.M = M; args.N = N; args.K = K;
#define SK_NT(TA, P, D) \
  return launch_linear_nt_bf16<TA, P, D>(a, w, pitch, d_pitch, args, s)
  if (a_f32 && prng_T > 0) SK_NT(float, true, false);
  if (a_f32) SK_NT(float, false, false);
  if (prng_T > 0) SK_NT(__nv_bfloat16, true, false);
  if (drop != nullptr) SK_NT(__nv_bfloat16, false, false);
  SK_NT(__nv_bfloat16, false, true);
#undef SK_NT
}

// dW = x^T . (y * mask) over all M rows into out (K, N) f32 and, with db
// non-null, db (N) = the f32 column sums of y * mask; M in `splits` slices
// of rows_per_split rows (a multiple of 64), their partials in ws / ws_db
// and counters (one a tile, zero) as the wrapper sizes them. bf16: y and
// the mask bytes are read with row pitches y_pitch / d_pitch >= N (16-byte
// rows, zero past N); f32: the pitches are N
int sk_linear_tn(int dtype, int b_f32, const void* x, const void* y,
                 int y_pitch, const void* drop, int d_pitch,
                 unsigned long long seed, int layer, int site, int prng_T,
                 int thresh, float keep_scale, void* out, void* db, void* ws,
                 void* ws_db, void* counters, int M, int K, int N, int splits,
                 int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prng_T > 0 && N % 4 != 0) return (int)cudaErrorInvalidValue;
  if (M < 1 || splits < 1 || rows_per_split % kTnSlab != 0 ||
      (long long)splits * rows_per_split < M ||
      (long long)(splits - 1) * rows_per_split >= M)
    return (int)cudaErrorInvalidValue;
  TnArgs a;
  a.y = y;
  a.drop = static_cast<const uint8_t*>(drop);
  a.prng = make_prng(seed, layer, site, prng_T);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.out = static_cast<float*>(out);
  a.db = static_cast<float*>(db);
  a.ws = static_cast<float*>(ws);
  a.ws_db = static_cast<float*>(ws_db);
  a.counters = static_cast<unsigned*>(counters);
  a.M = M; a.K = K; a.N = N; a.rows_per_split = rows_per_split;
  if (dtype == 0) {
    const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
    if (prng_T > 0)
      linear_tn_f32_kernel<true><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), a);
    else
      linear_tn_f32_kernel<false><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), a);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define SK_TN(TB, P) \
  return launch_linear_tn_bf16<TB, P>(x, y_pitch, d_pitch, a, splits, s)
  if (b_f32 && prng_T > 0) SK_TN(float, true);
  if (b_f32) SK_TN(float, false);
  if (prng_T > 0) SK_TN(__nv_bfloat16, true);
  SK_TN(__nv_bfloat16, false);
#undef SK_TN
}

int sk_encoder_attention(int dtype, const void* qkv, const void* key_bias,
                         const void* qn_s, const void* qn_b, const void* kn_s,
                         const void* kn_b, void* out, int B, int Tn, int H,
                         int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_attention_dh<float>(qkv, key_bias, qn_s, qn_b, kn_s, kn_b,
                                      out, B, Tn, H, Dh, scale, s);
  if (dtype == 1)
    return launch_attention_dh<__nv_bfloat16>(qkv, key_bias, qn_s, qn_b, kn_s,
                                              kn_b, out, B, Tn, H, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

int sk_layernorm_rows(int dtype, const void* x, const void* scale,
                      const void* bias, void* y, int M, int D, int blocks,
                      int warps, int lanes, int vecs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_layernorm_rows<float>(x, scale, bias, y, M, D, blocks,
                                        warps, lanes, vecs, s);
  if (dtype == 1)
    return launch_layernorm_rows<__nv_bfloat16>(x, scale, bias, y, M, D,
                                                blocks, warps, lanes, vecs, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
