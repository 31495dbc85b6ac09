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
//                      residual add. Serves QKV, the out-projection (+x),
//                      FFN-in (+ReLU) and FFN-out (+x).
//   encoder_attention  one block per (query tile, head, batch element); the
//                      full f32 score row of each query stays in shared
//                      memory (T <= 1024), so no online softmax is needed.
//   layernorm_rows     LN1 and LN2 ahead of QKV and FFN-in, and the final
//                      LayerNorm; one warp per row, f32 statistics.
//
// What bounds it on the card: at d_model=256 every product is small in K
// (256 or 512), so each layer moves its activations through device memory
// about seven times, and a product tile does little work per byte it loads.
// The products run on the tensor cores (WMMA, bf16 in, f32 accumulate) in
// 64x64 output tiles that load 16-byte vectors and prefetch the next
// K-slab into registers while the current one is multiplied; the attention
// runs on the FMA units. LayerNorm is its own pass and not a prologue of
// the product: as a prologue, each of the N/64 column blocks of a row
// block recomputed the same row statistics and normalisation, which took
// as long again as the QKV product itself. This first landing keeps the
// design simple to hold against the plain version: no TMA, no wgmma, no
// fusion across the layer's kernels. Those are later work.
//
// Numerics follow _stack_kernel exactly: every product accumulates in f32,
// is rounded to the compute dtype, and only then has the (rounded) bias
// added; LayerNorm statistics are f32 with var = max(E[x^2] - mu^2, 0) and
// eps 1e-6; scores are f32, scaled, plus the f32 key-mask bias (0 / -1e9);
// the unnormalised exponentials are rounded to the compute dtype before the
// P.V product and the f32 sum divides the f32 result afterwards.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <mma.h>

#include <stdint.h>
#include <type_traits>

#include "common.cuh"
#include "dropout_prng.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// linear: out[M,N] = epilogue(a[M,K] @ w[K,N])
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64;
constexpr int kPadA = 8, kPadB = 8, kPadC = 4;  // keep WMMA rows 32B-aligned

// K-slab depth: bf16 takes 64 (4-8 slabs at K = 256/512), f32 32 (its
// slabs are twice the bytes and its FMA tiles are the slow path anyway)
template <typename T>
struct Slab;
template <>
struct Slab<__nv_bfloat16> {
  static constexpr int BK = 64;
};
template <>
struct Slab<float> {
  static constexpr int BK = 32;
};

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks per SM
linear_kernel(const T* __restrict__ a, const T* __restrict__ w,
              const float* __restrict__ bias, const T* __restrict__ residual,
              const uint8_t* __restrict__ drop, DropPrng prng, int thresh,
              float keep_scale, T* __restrict__ out, int M, int N, int K,
              int relu) {
  constexpr int BK = Slab<T>::BK;
  constexpr int VW = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int LDA = BK + kPadA, LDB = BN + kPadB, LDC = BN + kPadC;
  constexpr int kVecA = BM * BK / VW / kThreads;  // vectors per thread
  constexpr int kVecB = BK * BN / VW / kThreads;
  constexpr int kBytesAB = (BM * LDA + BK * LDB) * (int)sizeof(T);
  constexpr int kBytesC = BM * LDC * (int)sizeof(float);
  // the operand slabs and, after the main loop, the f32 output tile
  __shared__ __align__(128)
      unsigned char smem[kBytesAB > kBytesC ? kBytesAB : kBytesC];
  T* as = reinterpret_cast<T*>(smem);  // [BM][LDA]
  T* bs = as + BM * LDA;               // [BK][LDB]
  float* cs = reinterpret_cast<float*>(smem);  // [BM][LDC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  // bf16: 8 warps as 4 (rows) x 2 (cols), each a 16x32 WMMA strip.
  // f32:  16x16 threads, each a 4x4 register tile strided by 16.
  const int wm = warp >> 1, wn = warp & 1;
  const int ty = tid >> 4, tx = tid & 15;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      cfrag[2];
  float acc[4][4];
  if constexpr (kTensorCores) {
    nvcuda::wmma::fill_fragment(cfrag[0], 0.f);
    nvcuda::wmma::fill_fragment(cfrag[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // next slab in registers: its loads are in flight while the current
  // slab is multiplied out of shared memory
  uint4 ra[kVecA], rb[kVecB];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kVecA; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BK / VW), c = (v % (BK / VW)) * VW;
      ra[i] = load_vec<T, kVec>(a, K, m0 + r, k0 + c, M, K);
    }
#pragma unroll
    for (int i = 0; i < kVecB; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BN / VW), c = (v % (BN / VW)) * VW;
      rb[i] = load_vec<T, kVec>(w + n0, N, k0 + r, c, K, N - n0);
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
    if constexpr (kTensorCores) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                               __nv_bfloat16, nvcuda::wmma::row_major>
            fa;
        nvcuda::wmma::load_matrix_sync(fa, &as[wm * 16 * LDA + kk], LDA);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                 __nv_bfloat16, nvcuda::wmma::row_major>
              fb;
          nvcuda::wmma::load_matrix_sync(fb, &bs[kk * LDB + wn * 32 + f * 16],
                                         LDB);
          nvcuda::wmma::mma_sync(cfrag[f], fa, fb, cfrag[f]);
        }
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f<T>(as[(ty + 16 * i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f<T>(bs[kk * LDB + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // the slabs are dead: the output tile reuses their shared memory
  if constexpr (kTensorCores) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
      nvcuda::wmma::store_matrix_sync(&cs[wm * 16 * LDC + wn * 32 + f * 16],
                                      cfrag[f], LDC,
                                      nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float v = round_dt<T>(cs[r * LDC + c]);
      v = round_dt<T>(v + round_dt<T>(bias[n]));
      if (relu) v = fmaxf(v, 0.f);
      if (has_drop(drop, prng))  // u8-threshold dropout of the output
        v = drop_byte(drop, prng, m, n, N) >= (uint32_t)thresh
                ? round_dt<T>(v * keep_scale)
                : 0.f;
      if (residual != nullptr) v = to_f<T>(residual[(size_t)m * N + n]) + v;
      out[(size_t)m * N + n] = from_f<T>(v);
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
// Both stage each operand's tile as its rows arrive from device memory
// (coalesced loads, contiguous shared-memory stores) and run one WMMA / FMA
// inner loop, reading a transposed operand through a column-major fragment.
// The gradient operand (a for NT, y for TN) may be f32: it is multiplied by
// the dropout mask of its site (byte >= thresh -> keep_scale, else 0) in
// f32 and rounded to the compute dtype as it is staged (load_masked), which
// is where the TPU kernel rounds it (df.astype(dt)).
// linear_nt's epilogue optionally gates by a ReLU output (gate > 0, the
// FFN backward) and writes f32, or rounds to the compute dtype and adds a
// running sum (dmemory over the decoder's layers). linear_tn reduces over
// all M rows: grid.z splits M into slices whose f32 partial tiles land in
// out[z] and are summed in a fixed order by sum_rows, so the result does
// not depend on scheduling.

constexpr int TBK = 32;  // contraction slab of the NT / TN products

template <typename T>
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

// one TBK-deep slab: cfrag / acc += A[BM][TBK] . B[TBK][BN]. Each operand
// sits in shared memory as its global rows arrive, so the stores are
// contiguous: A as [BM][LDA] (kAT false) or [TBK][LDA] (kAT, A^T), B as
// [TBK][LDB] (kBT false) or [BN][LDB] (kBT, B^T); a transposed operand is
// read through a column-major WMMA fragment.
template <typename T, bool kAT, int LDA, bool kBT, int LDB>
__device__ __forceinline__ void mma_slab(const T* as, const T* bs,
                                         FragC<T> (&cfrag)[2],
                                         float (&acc)[4][4], int tid) {
  using namespace nvcuda;
  using LayoutA = std::conditional_t<kAT, wmma::col_major, wmma::row_major>;
  using LayoutB = std::conditional_t<kBT, wmma::col_major, wmma::row_major>;
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int ty = tid >> 4, tx = tid & 15;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> fa;
      wmma::load_matrix_sync(
          fa, kAT ? &as[kk * LDA + wm * 16] : &as[wm * 16 * LDA + kk], LDA);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int c = wn * 32 + f * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> fb;
        wmma::load_matrix_sync(fb, kBT ? &bs[c * LDB + kk] : &bs[kk * LDB + c],
                               LDB);
        wmma::mma_sync(cfrag[f], fa, fb, cfrag[f]);
      }
    }
  } else {
#pragma unroll 8
    for (int kk = 0; kk < TBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        av[i] = to_f<T>(kAT ? as[kk * LDA + r] : as[r * LDA + kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bv[j] = to_f<T>(kBT ? bs[c * LDB + kk] : bs[kk * LDB + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// the BM x BN f32 result tile into shared memory (cs, row stride LDC)
template <typename T, int LDC>
__device__ __forceinline__ void store_tile(float* cs, FragC<T> (&cfrag)[2],
                                           float (&acc)[4][4], int tid) {
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int ty = tid >> 4, tx = tid & 15;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
      nvcuda::wmma::store_matrix_sync(&cs[wm * 16 * LDC + wn * 32 + f * 16],
                                      cfrag[f], LDC,
                                      nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
}

template <typename T>
__device__ __forceinline__ void zero_acc(FragC<T> (&cfrag)[2],
                                         float (&acc)[4][4]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    nvcuda::wmma::fill_fragment(cfrag[0], 0.f);
    nvcuda::wmma::fill_fragment(cfrag[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// The gradient operand's kRows x kCols slab at (row0, col0) of an [.][N]
// array, each element f32 (or dt) times its dropout mask and rounded to the
// compute dtype, into kE registers a thread. 'bits' mode (kPrng false) reads
// the mask bytes from drop (or none) and gives thread tid the elements
// e = tid + i * kThreads (one column a lane); 'prng' mode draws them
// in-kernel and gives each thread four consecutive columns of a row per
// Philox call (N a multiple of 4), a quarter of the calls one element each
// would take. The two are separate instantiations, so the 'bits' kernels
// carry no Philox code in their main loop.
template <typename T, typename TA, int kRows, int kCols, bool kPrng>
__device__ __forceinline__ void load_masked(
    T (&reg)[kRows * kCols / kThreads], const TA* __restrict__ a,
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
        v = to_f<TA>(a[(size_t)m * N + n]);
        if (drop != nullptr)
          v *= drop[(size_t)m * N + n] >= (uint32_t)thresh ? keep_scale : 0.f;
      }
      reg[i] = from_f<T>(v);
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
          v = to_f<TA>(a[(size_t)m * N + n + j]);
          v *= ((wj[j] >> prng.shift) & 255u) >= (uint32_t)thresh ? keep_scale
                                                                   : 0.f;
        }
        reg[4 * i + j] = from_f<T>(v);
      }
    }
  }
}

// load_masked's registers into shared memory (row stride ld), same mapping
template <typename T, int kRows, int kCols, bool kPrng>
__device__ __forceinline__ void store_masked(
    const T (&reg)[kRows * kCols / kThreads], T* dst, int ld, int tid) {
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
template <typename T>
struct TrainSmem {  // NT: [BM][kLdaT] + [BN][kLdaT]; TN: 2 x [TBK][kLdbT]
  static constexpr int kAB = 2 * BM * kLdaT * (int)sizeof(T);
  static constexpr int kC = BM * kLdcT * (int)sizeof(float);
  static constexpr int kBytes = kAB > kC ? kAB : kC;
};

template <typename T, typename TA, typename TO, bool kPrng>
__global__ void __launch_bounds__(kThreads, 2)
linear_nt_kernel(const TA* __restrict__ a, const T* __restrict__ w,
                 const uint8_t* __restrict__ drop, DropPrng prng, int thresh,
                 float keep_scale, const T* __restrict__ gate,
                 const T* __restrict__ residual, TO* __restrict__ out, int M,
                 int N, int K) {
  // a [M][N] (contraction N), w [K][N]; out [M][K]
  __shared__ __align__(128) unsigned char smem[TrainSmem<T>::kBytes];
  T* as = reinterpret_cast<T*>(smem);  // [BM][kLdaT]: a rows
  T* bs = as + BM * kLdaT;             // [BN][kLdaT]: w rows (B^T)
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  FragC<T> cfrag[2];
  float acc[4][4];
  zero_acc<T>(cfrag, acc);
  T ra[kElemsA], rb[kElemsB];
  auto load_slab = [&](int n0) {
    load_masked<T, TA, BM, TBK, kPrng>(ra, a, drop, prng, m0, n0, M, N,
                                       thresh, keep_scale, tid);
#pragma unroll
    for (int i = 0; i < kElemsB; ++i) {
      const int e = tid + i * kThreads, c = e % TBK, r = e / TBK;
      const int k = k0 + r, n = n0 + c;
      rb[i] = k < K && n < N ? w[(size_t)k * N + n] : from_f<T>(0.f);
    }
  };
  load_slab(0);
  for (int n0 = 0; n0 < N; n0 += TBK) {
    store_masked<T, BM, TBK, kPrng>(ra, as, kLdaT, tid);
#pragma unroll
    for (int i = 0; i < kElemsB; ++i) {
      const int e = tid + i * kThreads;
      bs[(e / TBK) * kLdaT + e % TBK] = rb[i];
    }
    __syncthreads();
    if (n0 + TBK < N) load_slab(n0 + TBK);
    mma_slab<T, false, kLdaT, true, kLdaT>(as, bs, cfrag, acc, tid);
    __syncthreads();
  }
  store_tile<T, kLdcT>(cs, cfrag, acc, tid);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, k = k0 + c;
    if (m < M && k < K) {
      const size_t o = (size_t)m * K + k;
      float v = cs[r * kLdcT + c];
      if (gate != nullptr && !(to_f<T>(gate[o]) > 0.f)) v = 0.f;
      if (residual != nullptr) v = to_f<T>(residual[o]) + round_dt<T>(v);
      out[o] = from_f<TO>(v);
    }
  }
}

template <typename T, typename TB, bool kPrng>
__global__ void __launch_bounds__(kThreads, 2)
linear_tn_kernel(const T* __restrict__ x, const TB* __restrict__ y,
                 const uint8_t* __restrict__ drop, DropPrng prng, int thresh,
                 float keep_scale, float* __restrict__ out, int M, int K,
                 int N, int rows_per_split) {
  // x [M][K], y [M][N]; out[z] [K][N] sums rows [z*rps, (z+1)*rps)
  __shared__ __align__(128) unsigned char smem[TrainSmem<T>::kBytes];
  T* as = reinterpret_cast<T*>(smem);  // [TBK][kLdbT]: x rows (A^T)
  T* bs = as + TBK * kLdbT;            // [TBK][kLdbT]: y rows
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int kr0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int mb = blockIdx.z * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  FragC<T> cfrag[2];
  float acc[4][4];
  zero_acc<T>(cfrag, acc);
  T ra[kElemsA], rb[kElemsB];
  auto load_slab = [&](int m0) {
#pragma unroll
    for (int i = 0; i < kElemsA; ++i) {
      const int e = tid + i * kThreads, r = e % BM, c = e / BM;
      const int m = m0 + c, k = kr0 + r;
      ra[i] = m < me && k < K ? x[(size_t)m * K + k] : from_f<T>(0.f);
    }
    load_masked<T, TB, TBK, BN, kPrng>(rb, y, drop, prng, m0, n0, me, N,
                                       thresh, keep_scale, tid);
  };
  load_slab(mb);
  for (int m0 = mb; m0 < me; m0 += TBK) {
#pragma unroll
    for (int i = 0; i < kElemsA; ++i) {
      const int e = tid + i * kThreads;
      as[(e / BM) * kLdbT + e % BM] = ra[i];
    }
    store_masked<T, TBK, BN, kPrng>(rb, bs, kLdbT, tid);
    __syncthreads();
    if (m0 + TBK < me) load_slab(m0 + TBK);
    mma_slab<T, true, kLdbT, false, kLdbT>(as, bs, cfrag, acc, tid);
    __syncthreads();
  }
  store_tile<T, kLdcT>(cs, cfrag, acc, tid);
  __syncthreads();
  float* dst = out + (size_t)blockIdx.z * K * N;
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int k = kr0 + r, n = n0 + c;
    if (k < K && n < N) dst[(size_t)k * N + n] = cs[r * kLdcT + c];
  }
}

// ---------------------------------------------------------------------------
// encoder_attention: out[b, t, h*Dh:(h+1)*Dh] over a (B, T, 3*H*Dh) qkv pane
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
// layernorm_rows: y = LN(x) over the last axis, one warp per row
// ---------------------------------------------------------------------------

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

template <typename T>
bool vector_ok(const void* p, int cols) {
  return cols % (16 / (int)sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_linear(const void* a, const void* w, const void* bias,
                  const void* residual, const void* drop, DropPrng prng,
                  int thresh, float keep_scale, void* out, int M, int N, int K,
                  int relu, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = vector_ok<T>(a, K) && vector_ok<T>(w, N);
  auto kernel = vec ? linear_kernel<T, true> : linear_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(residual),
      static_cast<const uint8_t*>(drop), prng, thresh, keep_scale,
      static_cast<T*>(out), M, N, K, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layernorm_rows(const void* x, const void* scale, const void* bias,
                          void* y, int M, int D, cudaStream_t stream) {
  const dim3 grid((M + kWarps - 1) / kWarps);
  const bool vec = vector_ok<T>(x, D) && vector_ok<T>(y, D);
  auto kernel =
      vec ? layernorm_rows_kernel<T, true> : layernorm_rows_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), M, D);
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


template <typename T, bool kPrng>
int launch_linear_nt(int a_f32, const void* a, const void* w, const void* drop,
                     DropPrng prng, int thresh, float keep_scale,
                     const void* gate,
                     const void* residual, int out_f32, void* out, int M,
                     int N, int K, cudaStream_t stream) {
  const dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM);
  const T* wp = static_cast<const T*>(w);
  const uint8_t* dp = static_cast<const uint8_t*>(drop);
  const T* gp = static_cast<const T*>(gate);
  const T* rp = static_cast<const T*>(residual);
  if (a_f32 && out_f32)
    linear_nt_kernel<T, float, float, kPrng><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(a), wp, dp, prng, thresh, keep_scale, gp, rp,
        static_cast<float*>(out), M, N, K);
  else if (a_f32)
    linear_nt_kernel<T, float, T, kPrng><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(a), wp, dp, prng, thresh, keep_scale, gp, rp,
        static_cast<T*>(out), M, N, K);
  else if (out_f32)
    linear_nt_kernel<T, T, float, kPrng><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), wp, dp, prng, thresh, keep_scale, gp, rp,
        static_cast<float*>(out), M, N, K);
  else
    linear_nt_kernel<T, T, T, kPrng><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), wp, dp, prng, thresh, keep_scale, gp, rp,
        static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <typename T, bool kPrng>
int launch_linear_tn(int b_f32, const void* x, const void* y, const void* drop,
                     DropPrng prng, int thresh, float keep_scale, void* out,
                     int M, int K, int N, int splits, cudaStream_t stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int rps = ((M + splits - 1) / splits + TBK - 1) / TBK * TBK;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* dp = static_cast<const uint8_t*>(drop);
  float* op = static_cast<float*>(out);
  if (b_f32)
    linear_tn_kernel<T, float, kPrng><<<grid, kThreads, 0, stream>>>(
        xp, static_cast<const float*>(y), dp, prng, thresh, keep_scale, op, M,
        K, N,
        rps);
  else
    linear_tn_kernel<T, T, kPrng><<<grid, kThreads, 0, stream>>>(
        xp, static_cast<const T*>(y), dp, prng, thresh, keep_scale, op, M, K,
        N,
        rps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" {

// the dropout operand of sk_linear, sk_linear_nt and sk_linear_tn: the u8
// bytes in drop, or (drop null, prng_T > 0) site `site` of layer `layer`
// drawn in-kernel from seed, rows m = b * prng_T + t (dropout_prng.cuh)
int sk_linear(int dtype, const void* a, const void* w, const void* bias,
              const void* residual, const void* drop, unsigned long long seed,
              int layer, int site, int prng_T, int thresh, float keep_scale,
              void* out, int M, int N, int K, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropPrng p = make_prng(seed, layer, site, prng_T);
  if (dtype == 0)
    return launch_linear<float>(a, w, bias, residual, drop, p, thresh,
                                keep_scale, out, M, N, K, relu, s);
  if (dtype == 1)
    return launch_linear<__nv_bfloat16>(a, w, bias, residual, drop, p, thresh,
                                        keep_scale, out, M, N, K, relu, s);
  return (int)cudaErrorInvalidValue;
}

int sk_linear_nt(int dtype, int a_f32, const void* a, const void* w,
                 const void* drop, unsigned long long seed, int layer,
                 int site, int prng_T, int thresh, float keep_scale,
                 const void* gate, const void* residual, int out_f32,
                 void* out, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropPrng p = make_prng(seed, layer, site, prng_T);
  if (prng_T > 0 && N % 4 != 0) return (int)cudaErrorInvalidValue;
#define SK_NT(T, P)                                                        \
  return launch_linear_nt<T, P>(a_f32, a, w, drop, p, thresh, keep_scale, \
                                gate, residual, out_f32, out, M, N, K, s)
  if (dtype == 0 && prng_T > 0) SK_NT(float, true);
  if (dtype == 0) SK_NT(float, false);
  if (dtype == 1 && prng_T > 0) SK_NT(__nv_bfloat16, true);
  if (dtype == 1) SK_NT(__nv_bfloat16, false);
#undef SK_NT
  return (int)cudaErrorInvalidValue;
}

int sk_linear_tn(int dtype, int b_f32, const void* x, const void* y,
                 const void* drop, unsigned long long seed, int layer,
                 int site, int prng_T, int thresh, float keep_scale, void* out,
                 int M, int K, int N, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropPrng p = make_prng(seed, layer, site, prng_T);
  if (prng_T > 0 && N % 4 != 0) return (int)cudaErrorInvalidValue;
#define SK_TN(T, P)                                                         \
  return launch_linear_tn<T, P>(b_f32, x, y, drop, p, thresh, keep_scale, \
                                out, M, K, N, splits, s)
  if (dtype == 0 && prng_T > 0) SK_TN(float, true);
  if (dtype == 0) SK_TN(float, false);
  if (dtype == 1 && prng_T > 0) SK_TN(__nv_bfloat16, true);
  if (dtype == 1) SK_TN(__nv_bfloat16, false);
#undef SK_TN
  return (int)cudaErrorInvalidValue;
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
                      const void* bias, void* y, int M, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_layernorm_rows<float>(x, scale, bias, y, M, D, s);
  if (dtype == 1)
    return launch_layernorm_rows<__nv_bfloat16>(x, scale, bias, y, M, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
