// Hopper (sm_90a) kernels for the token head fused with its cross-entropy:
// the (M, V) logits never reach device memory.
//
// Replaces the TPU kernel sketchformer_tpu/ops/pallas_ce.py::token_ce_rows
// (forward _ce_fwd_kernel, backward _ce_bwd_kernel). For rows x (M, d) in
// the compute dtype, the head kernel W (d, V) rounded to it and the f32
// bias b (V,), with l = x . W + b in f32 (f32 accumulation, the bias added
// in f32, never rounded to the compute dtype):
//
//   ce_fwd  ll = l[tgt] - lse, corr = (first-index argmax == tgt) and the
//           logsumexp lse, per row (M,) f32;
//   ce_dx   dl = (onehot(tgt) - exp(l - lse)) * gll in f32, rounded to the
//           compute dtype for the product (pallas_ce.py:93); dx = dl . W^T;
//   ce_dw   dW = x^T . dl (f32) and db = the column sums of the unrounded
//           f32 dl (pallas_ce.py:104), per M slice: each slice writes f32
//           partials that the last block of each vocab tile adds in a fixed
//           order in the same launch (split_reduce.cuh).
//
// Design. In bf16 all three are warp-specialised wgmma kernels fed by TMA
// (ce_fwd_wgmma_kernel, ce_dx_wgmma_kernel and ce_dw_wgmma_kernel, see
// their notes). In f32: a block owns a 64-row tile (forward and dx) or a
// 64-column vocab tile and an M slice (dW). The operand it keeps (the rows,
// or the W tile) stays in shared memory while it streams the other; each
// 64 x 64 logits tile is an FMA product into shared memory and is reduced
// there on the spot: the forward keeps a running max, sum of exponentials,
// target logit and first argmax per row (four threads a row, combined at
// the end); the backward turns the tile into dl and multiplies it out. No
// atomics: every sum has a fixed order, so re-runs are bit-stable. Each
// backward kernel recomputes the logits from (x, W, b) instead of reading
// them; the TPU kernel recomputes once and does both products, so the dW
// kernel's recompute is work the TPU design does not do.
//
// The wrapper (ops/token_ce.py) pads d and V to multiples of 64 (zero
// rows and columns of W; columns >= V are excluded here by index, as the
// JAX kernel's NEG_INF bias padding does on the TPU's 128 lanes).
//
// What bounds it on the card: the products, 2 M d V operations for the
// forward and 4 x that for the backward (a recompute and a product in each
// of dx and dW). At d = 256 a row tile does 2 * 64 * 256 operations per W
// element it stages, so the tiles are tensor-core bound only with a
// well-fed pipeline: in bf16 each kernel runs a TMA ring into wgmma (f32
// stages synchronously onto the FMA units). The forward also takes an
// exponential and a few compares a logit on the FMA and special-function
// units, which the second consumer warpgroup's products overlap.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "split_reduce.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 register tile
constexpr int BM = 64;         // rows of a tile
constexpr int BN = 64;         // vocab columns of a tile
constexpr int kPad = 8;        // shared-memory row pad (elements)
constexpr int kLdc = BN + 4;   // f32 logits tile row stride

// one 64 x 64 f32 tile += A (64 x K) . B (K x 64) on the FMA units, both in
// shared memory: A(i, k) = as[i * lda + k] (kAT: as[k * lda + i]), B(k, j) =
// bs[k * ldb + j] (kBT: bs[j * ldb + k]); each thread a 4 x 4 register tile
// strided by 16
template <bool kAT, bool kBT>
__device__ __forceinline__ void mma_tile(const float* as, int lda,
                                         const float* bs,
                                         int ldb, int K, float (&acc)[4][4],
                                         int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      av[i] = kAT ? as[kk * lda + r] : as[r * lda + kk];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      bv[j] = kBT ? bs[c * ldb + kk] : bs[kk * ldb + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the 64 x 64 tile into shared memory, row stride kLdc
__device__ __forceinline__ void store_tile(float* cs, const float (&acc)[4][4],
                                           int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[(ty + 16 * i) * kLdc + tx + 16 * j] = acc[i][j];
}

// rows x cols of f32 (cols a multiple of the 16-byte vector, src rows
// 16-byte aligned) from device memory into shared memory; rows >= valid are
// zeros
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src,
                                      size_t lds, int rows, int cols,
                                      int valid, int tid) {
  constexpr int VW = 4;
  const int per_row = cols / VW;
  for (int v = tid; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v - r * per_row) * VW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

// shared-memory layout of the three f32 kernels (every part a multiple of
// 128 bytes): xs [BM][dp + kPad] rows, ws [dp][BN + kPad] a W tile, cs
// [BM][kLdc] logits, ds [BM][BN + kPad] dl, then per-row (lse, gll, tgt)
// and the db reduction rows
size_t smem_bytes(int dp) {
  return sizeof(float) * ((size_t)BM * (dp + kPad) + (size_t)dp * (BN + kPad) +
                          (size_t)BM * (BN + kPad) + (size_t)BM * kLdc +
                          3 * BM + 4 * BN);
}

struct Parts {
  float *xs, *ws, *ds;
  float *cs, *rl, *rg, *red;
  int* rt;
  __device__ Parts(unsigned char* base, int dp) {
    xs = reinterpret_cast<float*>(base);
    ws = xs + BM * (dp + kPad);
    ds = ws + dp * (BN + kPad);
    cs = reinterpret_cast<float*>(ds + BM * (BN + kPad));
    rl = cs + BM * kLdc;
    rg = rl + BM;
    rt = reinterpret_cast<int*>(rg + BM);
    red = reinterpret_cast<float*>(rt + BM);
  }
};

// logits tile (rows m0.., vocab n0..) = xs . ws into cs (synchronised)
__device__ __forceinline__ void logits_tile(const Parts& s, int dp, int tid) {
  float acc[4][4] = {};
  mma_tile<false, false>(s.xs, dp + kPad, s.ws, BN + kPad, dp, acc, tid);
  store_tile(s.cs, acc, tid);
  __syncthreads();
}

// the row statistics of the backward for rows m0 .. m0+63 (rows >= M get a
// zero gradient)
__device__ __forceinline__ void load_rows(const Parts& s,
                                          const int* __restrict__ tgt,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ gll,
                                          int m0, int me, int tid) {
  if (tid < BM) {
    const int m = m0 + tid;
    const bool ok = m < me;
    s.rl[tid] = ok ? lse[m] : 0.f;
    s.rg[tid] = ok ? gll[m] : 0.f;
    s.rt[tid] = ok ? tgt[m] : -1;
  }
}

// dl of element (r, c) of the logits tile at vocab n0 (0 outside the vocab)
__device__ __forceinline__ float dlogit(const Parts& s,
                                        const float* __restrict__ bias, int r,
                                        int c, int n0, int V) {
  const int n = n0 + c;
  if (n >= V) return 0.f;
  const float p = expf(s.cs[r * kLdc + c] + bias[n] - s.rl[r]);
  return ((n == s.rt[r] ? 1.f : 0.f) - p) * s.rg[r];
}

// ---------------------------------------------------------------------------
// forward: one block per 64-row tile, all vocab tiles
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const int* __restrict__ tgt,
              float* __restrict__ ll, float* __restrict__ corr,
              float* __restrict__ lse, int M, int dp, int V, int Vp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Parts s(smem, dp);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  stage(s.xs, dp + kPad, x + (size_t)m0 * dp, dp, BM, dp, M - m0, tid);
  // four threads a row, each a quarter of every tile's columns
  const int r = tid >> 2, q = tid & 3, m = m0 + r;
  const int tg = m < M ? tgt[m] : -1;
  float rmax = -INFINITY, rsum = 0.f, tl = 0.f, bval = -INFINITY;
  int bidx = INT_MAX;
  for (int n0 = 0; n0 < V; n0 += BN) {
    __syncthreads();  // the previous tile's reads of ws and cs are done
    stage(s.ws, BN + kPad, w + n0, Vp, dp, BN, dp, tid);
    __syncthreads();
    logits_tile(s, dp, tid);
    float v[16];
    float lm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = q * 16 + j, n = n0 + c;
      v[j] = n < V ? s.cs[r * kLdc + c] + bias[n] : -INFINITY;
      lm = fmaxf(lm, v[j]);
      if (n == tg) tl = v[j];
      if (v[j] > bval) {  // columns in increasing order: the first max stays
        bval = v[j];
        bidx = n;
      }
    }
    if (lm == -INFINITY) continue;  // no column of this tile in the vocab
    if (lm > rmax) {
      rsum *= expf(rmax - lm);
      rmax = lm;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) rsum += expf(v[j] - rmax);
  }
  // combine the row's four threads (neighbouring lanes)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, rmax, off);
    const float os = __shfl_xor_sync(0xffffffffu, rsum, off);
    const float nm = fmaxf(rmax, om);
    rsum = (rmax == -INFINITY ? 0.f : rsum * expf(rmax - nm)) +
           (om == -INFINITY ? 0.f : os * expf(om - nm));
    rmax = nm;
    const float ov = __shfl_xor_sync(0xffffffffu, bval, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (ov > bval || (ov == bval && oi < bidx)) {
      bval = ov;
      bidx = oi;
    }
    tl += __shfl_xor_sync(0xffffffffu, tl, off);
  }
  if (q == 0 && m < M) {
    const float l = rmax + logf(rsum);
    lse[m] = l;
    ll[m] = tl - l;
    corr[m] = bidx == tg ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward, dx: one block per 64-row tile, dx accumulated over all vocab
// tiles in registers (NG groups of 64 columns of dp)
// ---------------------------------------------------------------------------

template <int NG>
__global__ void __launch_bounds__(kThreads)
ce_dx_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ gll,
             float* __restrict__ dx, int M, int dp, int V, int Vp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Parts s(smem, dp);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  stage(s.xs, dp + kPad, x + (size_t)m0 * dp, dp, BM, dp, M - m0, tid);
  load_rows(s, tgt, lse, gll, m0, M, tid);
  float acc[NG][4][4] = {};
  for (int n0 = 0; n0 < V; n0 += BN) {
    __syncthreads();
    stage(s.ws, BN + kPad, w + n0, Vp, dp, BN, dp, tid);
    __syncthreads();
    logits_tile(s, dp, tid);
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e - r * BN;
      s.ds[r * (BN + kPad) + c] = dlogit(s, bias, r, c, n0, V);
    }
    __syncthreads();
    // dx[:, g*64 ..] += dl (64 x 64) . W[g*64 .., n0 ..]^T
#pragma unroll
    for (int g = 0; g < NG; ++g)
      mma_tile<false, true>(s.ds, BN + kPad, s.ws + g * BM * (BN + kPad),
                            BN + kPad, BN, acc[g], tid);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    __syncthreads();
    store_tile(s.cs, acc[g], tid);
    __syncthreads();
    for (int e = tid; e < BM * BM; e += kThreads) {
      const int r = e / BM, c = e - r * BM;
      if (m0 + r < M)
        dx[(size_t)(m0 + r) * dp + g * BM + c] = s.cs[r * kLdc + c];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dx in bf16: wgmma products fed by a TMA ring
// ---------------------------------------------------------------------------
//
// The forward of a flash-attention kernel with W in the place of K and V. A
// block owns 128 rows: two consumer warpgroups of 64 and a producer
// warpgroup whose first thread issues every TMA load. The x slab (128 x dp,
// 128-byte swizzle) comes in once; W's 64-column vocab tiles (dp x 64) stream
// through a ring of kDxStages mbarrier stages. For each tile a consumer
//   - forms S = x . W_tile by wgmma m64n64k16, both operands in shared
//     memory (x K-major, the tile MN-major);
//   - turns the f32 accumulator into dl in registers, the bias, lse, gll and
//     the target per row in registers, columns >= V excluded by index;
//   - rounds dl to bf16 straight into wgmma A fragments (the accumulator's
//     layout is the A-fragment layout);
//   - runs dx += dl . W_tile^T by wgmma m64n64k16 with A in registers, the
//     same staged tile read K-major through the descriptor: no transposed
//     copy.
// dx (64 x dp f32, dp / 2 registers a thread) stays in registers over all
// vocab tiles, summed in one fixed order without atomics (bit-stable), and
// setmaxnreg moves registers from the producer to the consumers. Rows >= M
// come in as TMA zeros and get a zero gradient. W is read from L2 once per
// 128 rows.

constexpr int kDxRows = 128;           // rows a block: two warpgroups of 64
constexpr int kDxStages = 4;           // W tiles in flight
constexpr int kDxThreads = 384;        // consumers 0-1, producer warpgroup 2
constexpr int kDxBox = kDxRows * 128;  // a 128-row x 64-column bf16 x box

// dynamic shared memory of a dx block (bytes): 1024 to align the swizzle
// atoms, the x slab (dp / 64 boxes), the ring (dp rows of 128 bytes a
// stage) and its barriers
constexpr size_t dx_smem_bytes(int dp) {
  return 1024 + (size_t)dp / 64 * kDxBox + (size_t)kDxStages * dp * 128 +
         (2 * kDxStages + 1) * sizeof(uint64_t);
}

template <int NG>
__global__ void __launch_bounds__(kDxThreads, 1)
ce_dx_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ bias, const int* __restrict__ tgt,
                   const float* __restrict__ lse,
                   const float* __restrict__ gll,
                   __nv_bfloat16* __restrict__ dx, int M, int V) {
  constexpr int dp = NG * 64;
  constexpr int kStage = dp * 128;  // a W tile: dp rows of 64 columns
  extern __shared__ unsigned char dx_smem_raw[];
  unsigned char* smem =
      dx_smem_raw + ((1024u - (smem_u32(dx_smem_raw) & 1023u)) & 1023u);
  unsigned char* xs = smem;                 // NG boxes of [128 rows][128 B]
  unsigned char* ring = xs + NG * kDxBox;   // kDxStages tiles of [dp][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDxStages * kStage);
  uint64_t* empty = full + kDxStages;
  uint64_t* xbar = empty + kDxStages;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.x * kDxRows;
  const int ntiles = (V + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 256);
    }
    mbar_init(smem_u32(xbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: the x slab, then vocab tile i into stage i % kDxStages
    // once both consumers have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (t == 0) {
      mbar_arrive_expect_tx(smem_u32(xbar), NG * kDxBox);
      for (int g = 0; g < NG; ++g)
        tma_load_2d(smem_u32(xs + g * kDxBox), &xmap, smem_u32(xbar), g * 64,
                    m0);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kDxStages;
        mbar_wait(smem_u32(empty + s), ((i / kDxStages) & 1) ^ 1);
        mbar_arrive_expect_tx(smem_u32(full + s), kStage);
        tma_load_2d(smem_u32(ring + s * kStage), &wmap, smem_u32(full + s),
                    i * 64, 0);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows m0 + 64 wg .. + 63; this thread rows
  // rbase and rbase + 8, columns 8 j + c2 (+ 1) of each 8-column block j
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int warp = t >> 5, lane = t & 31, c2 = 2 * (lane & 3);
  const int rbase = m0 + wg * 64 + warp * 16 + (lane >> 2);
  float rl[2], rg[2];
  int rt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = rbase + 8 * r;
    const bool ok = m < M;
    rl[r] = ok ? lse[m] : INFINITY;  // exp(. - inf) = 0: no gradient
    rg[r] = ok ? gll[m] : 0.f;
    rt[r] = ok ? tgt[m] : -1;
  }
  float acc[NG][32];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
  const uint32_t xa = smem_u32(xs) + wg * 64 * 128;
  mbar_wait(smem_u32(xbar), 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kDxStages, n0 = i * 64;
    float bv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + c2 + e;
        bv[2 * j + e] = n < V ? bias[n] : 0.f;
      }
    mbar_wait(smem_u32(full + s), (i / kDxStages) & 1);
    const uint32_t ws = smem_u32(ring + s * kStage);
    float sc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) sc[q] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < dp / 16; ++kk)  // S = x . W_tile over dp
      wgmma_m64n64_ss(sc, sw128_desc(xa + (kk >> 2) * kDxBox + (kk & 3) * 32,
                                     16),
                      sw128_desc(ws + kk * 2048, 16));
    wgmma_commit();
    wgmma_wait<0>();
    // dl = (onehot - exp(l - lse)) * gll, l = S + bias, rounded into A
    // fragments: element q of block j is row rbase + 8 (q / 2), column
    // n0 + 8 j + c2 + q % 2
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q >> 1, e = q & 1, n = n0 + 8 * j + c2 + e;
        const float p = expf(sc[4 * j + q] + bv[2 * j + e] - rl[r]);
        sc[4 * j + q] = n < V ? ((n == rt[r] ? 1.f : 0.f) - p) * rg[r] : 0.f;
      }
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        af[kk][h] = pack_bf16(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dx += dl . W_tile^T over the tile
#pragma unroll
      for (int g = 0; g < NG; ++g)
        wgmma_m64n64_rs(acc[g], af[kk],
                        sw128_desc(ws + g * 64 * 128 + kk * 32, 16));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(smem_u32(empty + s));
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = rbase + 8 * r;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)m * dp + g * 64 +
                                             8 * j + c2) =
              __floats2bfloat162_rn(acc[g][4 * j + 2 * r],
                                    acc[g][4 * j + 2 * r + 1]);
      }
}

// ---------------------------------------------------------------------------
// forward in bf16: wgmma products fed by a TMA ring
// ---------------------------------------------------------------------------
//
// ce_dx_wgmma_kernel's shape with the row statistics in the place of the dx
// product. A block owns 128 rows: two consumer warpgroups of 64 and a
// producer warpgroup whose first thread issues every TMA load. The x slab
// (128 x dp, 128-byte swizzle) comes in once; W's 64-column vocab tiles (dp
// x 64) stream through a ring of `stages` mbarrier stages, as many as the
// block's shared memory holds (ops/token_ce.py::fwd_plan: 5 at dp = 256).
// Each consumer holds its 64 x rows in registers as wgmma A fragments, read
// once from the slab: per tile only the W tile (MN-major) is read from
// shared memory, whose bandwidth the two operands' reads would use up at
// the tensor cores' rate.
// For each tile it forms S = x . W_tile by wgmma m64n64k16 and folds l = S +
// b (f32, never rounded; columns >= V excluded by index) into its two rows'
// running max, sum of exponentials (rescaled when the max grows), target
// logit and first argmax, all in registers, while the products of its next
// tile run (two accumulator sets). The four lanes of a row, each 16 of a
// tile's 64 columns, are combined at the end with ce_fwd_kernel's tie rule
// (the larger value, on equal values the smaller index). Rows >= M come in
// as TMA zeros and write nothing. setmaxnreg moves registers from the
// producer to the consumers. W is read from L2 once per 128 rows.
//
// What bounds it: operations, 2 M d V on the tensor cores and an exponential
// a logit on the special-function units.

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; 0 for
// -inf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kSmemMax = 232448;  // shared memory a block may opt into

// dynamic shared memory of a forward block (bytes) with `stages` W tiles in
// flight: 1024 to align the swizzle atoms, the x slab, the ring and its
// barriers
constexpr size_t fwd_smem_bytes(int dp, int stages) {
  return 1024 + (size_t)dp / 64 * kDxBox + (size_t)stages * dp * 128 +
         (2 * stages + 1) * sizeof(uint64_t);
}

template <int NG>
__global__ void __launch_bounds__(kDxThreads, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ bias,
                    const int* __restrict__ tgt, float* __restrict__ ll,
                    float* __restrict__ corr, float* __restrict__ lse, int M,
                    int V, int stages) {
  constexpr int dp = NG * 64;
  constexpr int kStage = dp * 128;  // a W tile: dp rows of 64 columns
  extern __shared__ unsigned char fw_smem_raw[];
  unsigned char* smem =
      fw_smem_raw + ((1024u - (smem_u32(fw_smem_raw) & 1023u)) & 1023u);
  unsigned char* xs = smem;                 // NG boxes of [128 rows][128 B]
  unsigned char* ring = xs + NG * kDxBox;   // stages tiles of [dp][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStage);
  uint64_t* empty = full + stages;
  uint64_t* xbar = empty + stages;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.x * kDxRows;
  const int ntiles = (V + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 256);
    }
    mbar_init(smem_u32(xbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: the x slab, then vocab tile i into stage i % stages
    // once both consumers have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (t == 0) {
      mbar_arrive_expect_tx(smem_u32(xbar), NG * kDxBox);
      for (int g = 0; g < NG; ++g)
        tma_load_2d(smem_u32(xs + g * kDxBox), &xmap, smem_u32(xbar), g * 64,
                    m0);
      RingPos p;
      for (int i = 0; i < ntiles; ++i, p.next(stages)) {
        mbar_wait(smem_u32(empty + p.s), p.phase ^ 1u);
        mbar_arrive_expect_tx(smem_u32(full + p.s), kStage);
        tma_load_2d(smem_u32(ring + p.s * kStage), &wmap,
                    smem_u32(full + p.s), i * 64, 0);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows m0 + 64 wg .. + 63; this thread rows
  // rbase and rbase + 8, columns 8 j + c2 (+ 1) of each 8-column block j
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int warp = t >> 5, lane = t & 31, c2 = 2 * (lane & 3);
  const int rbase = m0 + wg * 64 + warp * 16 + (lane >> 2);
  int rt[2], bidx[2];
  float rmax[2], rsum[2], tl[2], bval[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = rbase + 8 * r;
    rt[r] = m < M ? tgt[m] : -1;
    rmax[r] = bval[r] = -INFINITY;
    rsum[r] = tl[r] = 0.f;
    bidx[r] = INT_MAX;
  }
  // the warpgroup's 64 x rows as wgmma A fragments in registers, read once
  // from the swizzled slab: k-step kk (16 columns) is box kk / 4, 16-byte
  // chunks 2 (kk % 4) (+ 1); ldmatrix lane l gives the address of row
  // l % 8 + 8 (l / 8 % 2) of the warp's 16, chunk + l / 16
  uint32_t xf[dp / 16][4];
  mbar_wait(smem_u32(xbar), 0);
  {
    const int R = wg * 64 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < dp / 16; ++kk) {
      const int chunk = 2 * (kk & 3) + (lane >> 4);
      ldsm_x4(xf[kk], smem_u32(xs + (kk >> 2) * kDxBox + R * 128 +
                               ((chunk ^ (R & 7)) << 4)));
    }
  }
  // tile i's bias (columns >= V: 0) and products S = x . W_tile over dp
  auto bias_of = [&](float (&bv)[16], int i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = i * 64 + 8 * j + c2 + e;
        bv[2 * j + e] = n < V ? bias[n] : 0.f;
      }
  };
  // the ring positions of the next tile to issue and the next to take
  RingPos at_issue, at_take;
  auto issue = [&](float (&sc)[32]) {
    mbar_wait(smem_u32(full + at_issue.s), at_issue.phase);
    const uint32_t ws = smem_u32(ring + at_issue.s * kStage);
    at_issue.next(stages);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < dp / 16; ++kk)  // the first product overwrites sc
      wgmma_m64n64_rs_mn(sc, xf[kk], sw128_desc(ws + kk * 2048, 16), kk > 0);
    wgmma_commit();
  };
  // tile i's products done (the next tile's, if issued, still running):
  // its stage is released and its registers read only after the wait
  auto take = [&](float (&sc)[32], bool next_issued) {
    if (next_issued)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 32; ++q) asm volatile("" : "+f"(sc[q])::"memory");
    mbar_arrive(smem_u32(empty + at_take.s));
    at_take.next(stages);
  };
  // element 4 j + 2 r + e of sc: row rbase + 8 r, column n0 + 8 j + c2 + e,
  // the thread's columns in increasing order. A logit costs an add, a max,
  // an FFMA and an exp2: the target is looked for only in the tile that
  // holds it, the first argmax only in a tile whose max beats the running
  // one (the earlier tile keeps a tie), the vocab's end only in the last
  // tile
  auto fold = [&](const float (&sc)[32], const float (&bv)[16], int i) {
    const int n0 = i * 64;
    const bool edge = n0 + 64 > V;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lm = -INFINITY, l[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[4 * j + 2 * r + e] + bv[2 * j + e];
          if (edge && n0 + 8 * j + c2 + e >= V) v = -INFINITY;
          l[2 * j + e] = v;
          lm = fmaxf(lm, v);
        }
      if ((unsigned)(rt[r] - n0) < 64u) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + 8 * j + c2 + e == rt[r]) tl[r] = l[2 * j + e];
      }
      if (lm > bval[r]) {
        bval[r] = lm;
#pragma unroll
        for (int k = 15; k >= 0; --k)
          if (l[k] == lm) bidx[r] = n0 + 8 * (k >> 1) + c2 + (k & 1);
      }
      if (lm == -INFINITY) continue;  // no column of this tile in the vocab
      if (lm > rmax[r]) {
        rsum[r] *= exp2_approx((rmax[r] - lm) * kLog2e);
        rmax[r] = lm;
      }
      const float mo = rmax[r] * kLog2e;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        rsum[r] += exp2_approx(fmaf(l[k], kLog2e, -mo));
    }
  };
  // two tiles in flight: tile i + 1's products run while tile i is folded
  float sa[32] = {}, sb[32] = {}, ba[16], bb[16];
  bias_of(ba, 0);
  issue(sa);
  for (int i = 0; i < ntiles; i += 2) {
    const bool odd = i + 1 < ntiles, even = i + 2 < ntiles;
    if (odd) {
      bias_of(bb, i + 1);
      issue(sb);
    }
    take(sa, odd);
    fold(sa, ba, i);
    if (!odd) break;
    if (even) {
      bias_of(ba, i + 2);
      issue(sa);
    }
    take(sb, even);
    fold(sb, bb, i + 1);
  }
  // combine each row's four lanes (neighbours in the quad)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, rmax[r], off);
      const float os = __shfl_xor_sync(0xffffffffu, rsum[r], off);
      const float nm = fmaxf(rmax[r], om);
      rsum[r] = (rmax[r] == -INFINITY ? 0.f : rsum[r] * expf(rmax[r] - nm)) +
                (om == -INFINITY ? 0.f : os * expf(om - nm));
      rmax[r] = nm;
      const float ov = __shfl_xor_sync(0xffffffffu, bval[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      if (ov > bval[r] || (ov == bval[r] && oi < bidx[r])) {
        bval[r] = ov;
        bidx[r] = oi;
      }
      tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], off);
    }
    const int m = rbase + 8 * r;
    if (c2 == 0 && m < M) {
      const float l = rmax[r] + logf(rsum[r]);
      lse[m] = l;
      ll[m] = tl[r] - l;
      corr[m] = bidx[r] == rt[r] ? 1.f : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dW and db: one block per (64-column vocab tile, M slice); the W
// tile stays in shared memory while the slice's row tiles stream through
// ---------------------------------------------------------------------------

// where a dW launch writes: dW (K rows = d, N columns = V) and db (N) f32,
// the splits' partials ws [tiles][splits][dp][64] and ws_db
// [tiles][splits][64], and one counter a tile (zero between launches)
struct DwOut {
  float* dw;
  float* db;
  float* ws;
  float* ws_db;
  unsigned* counters;
  int K, N;
};

template <int NG>
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ gll,
             DwOut o, int M, int dp, int V, int Vp, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int flag;
  const Parts s(smem, dp);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, z = blockIdx.y, splits = gridDim.y;
  const int mb = z * rows_per_split, me = min(M, mb + rows_per_split);
  stage(s.ws, BN + kPad, w + n0, Vp, dp, BN, dp, tid);
  float acc[NG][4][4] = {};
  const int c = tid % BN, r_first = tid / BN;  // this thread's dl column
  float db = 0.f;
  for (int m0 = mb; m0 < me; m0 += BM) {
    __syncthreads();
    stage(s.xs, dp + kPad, x + (size_t)m0 * dp, dp, BM, dp, me - m0, tid);
    load_rows(s, tgt, lse, gll, m0, me, tid);
    __syncthreads();
    logits_tile(s, dp, tid);
    for (int r = r_first; r < BM; r += kThreads / BN) {
      const float dl = dlogit(s, bias, r, c, n0, V);
      db += dl;
      s.ds[r * (BN + kPad) + c] = dl;
    }
    __syncthreads();
    // dW[g*64 .., n0 ..] += x[m0 .., g*64 ..]^T . dl
#pragma unroll
    for (int g = 0; g < NG; ++g)
      mma_tile<true, false>(s.xs + g * BM, dp + kPad, s.ds, BN + kPad, BM,
                            acc[g], tid);
  }
  const size_t part = (size_t)blockIdx.x * splits + z;
  float* dst = o.ws + part * dp * BN;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    __syncthreads();
    store_tile(s.cs, acc[g], tid);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, cc = e - r * BN;
      dst[(g * BM + r) * BN + cc] = s.cs[r * kLdc + cc];
    }
  }
  // db: the four threads of a column, added in a fixed order
  s.red[r_first * BN + c] = db;
  __syncthreads();
  if (tid < BN) {
    float t = 0.f;
    for (int i = 0; i < kThreads / BN; ++i) t += s.red[i * BN + tid];
    o.ws_db[part * BN + tid] = t;
  }
  if (split_last_block(o.counters + blockIdx.x, splits, &flag))
    split_reduce<NG * BM, BN>(o.ws + (size_t)blockIdx.x * splits * dp * BN,
                              splits, o.dw, o.K, o.N, 0, n0,
                              o.ws_db + (size_t)blockIdx.x * splits * BN,
                              o.db);
}

// ---------------------------------------------------------------------------
// backward, dW and db in bf16: wgmma products fed by a TMA ring
// ---------------------------------------------------------------------------
//
// ce_dx_wgmma_kernel with the roles of x and W swapped. A block owns one
// 64-column vocab tile of W (dp x 64, one TMA box, 128-byte swizzle, kept in
// shared memory) and one M slice, whose 64-row x slabs stream through a
// ring of dw_stages(dp) mbarrier stages that the first thread of a producer
// warpgroup keeps full (setmaxnreg moves the producer's registers to the
// consumers). The two consumer warpgroups take alternate slabs and never
// wait for each other, so one's exponentials run while the other's products
// do. For each of its slabs a consumer warpgroup
//   - forms S = x . W_tile by wgmma m64n64k16, both operands in shared
//     memory (x K-major, the tile MN-major), as ce_dx does;
//   - turns the f32 accumulator into dl in registers (lse, gll and the
//     target per row, the bias per column, columns >= V excluded by index),
//     adds the f32 dl into its columns' db partials before any rounding,
//     rounds it to bf16 into its own 128-byte-swizzled dl tile and fences
//     it for the async proxy;
//   - runs dW_tile += x_slab^T . dl by wgmma m64n64k16 with both operands
//     MN-major: the same staged x slab read transposed through its
//     descriptor, no copy. Each warpgroup keeps the whole dp x 64 dW tile
//     of its own slabs in registers.
// At the end warpgroup 1 hands its dW tile to warpgroup 0 through shared
// memory, which adds it to its own (the order fixed: 0, then 1) and writes
// the split's f32 partial; the last block of the vocab tile adds the
// splits' partials in the order z = 0..S-1 (split_reduce.cuh), so re-runs
// are bit-stable and no sum_rows follows. Rows >= M come in as TMA zeros
// and get a zero gradient.
//
// Tile width and splits: 64 columns keep a consumer thread's S tile (32
// registers) and its dW tile (128 at dp = 256) in registers. 157 tiles alone
// (V = 10,004) would fill 1.19 waves of 132 SMs (one block an SM: the ring
// takes 160 KB at dp = 256), so M is cut into the split count of at most 8
// whose grid fills its last wave best (ops/token_ce.py::dw_plan): 5 at the
// train shape, 785 blocks in 5.95 waves.
//
// What bounds it: the recompute and the product, 4 M d V operations, the
// same work as ce_dx (the TPU kernel's one recompute serves both
// products). Each block reads its slice's x slabs from L2 (x is 25 MB at
// the train shape), 157 times over in all. On the card its time, as
// ce_dx's, grows far less than its work with dp: a cost per slab that does
// not depend on dp (the dl phase and the products' latency within one
// warpgroup) sets it, not the products' rate.

constexpr int kDwRows = 64;            // rows of an x slab: one warpgroup's
constexpr int kDwThreads = 384;        // consumers 0-1, producer warpgroup 2
constexpr int kDwBox = kDwRows * 128;  // a 64-row x 64-column bf16 box
constexpr int kDwStagesMax = 8;
constexpr int kDwSmemMax = 232448;     // what a block may opt into

// the fixed parts of a dW block's dynamic shared memory (bytes): 1024 to
// align the swizzle atoms, the W tile, the two warpgroups' dl tiles, the db
// reduction rows, the barriers and the last-block flag
__host__ __device__ constexpr int dw_fixed_bytes(int ng) {
  return 1024 + ng * 64 * 128 + 2 * kDwBox + 8 * 64 * 4 +
         (2 * kDwStagesMax + 1) * 8 + 16;
}

// x slabs in flight at dp = 64 ng: as many as fit beside the fixed parts,
// at most kDwStagesMax
__host__ __device__ constexpr int dw_stages(int ng) {
  return (kDwSmemMax - dw_fixed_bytes(ng)) / (ng * kDwBox) < kDwStagesMax
             ? (kDwSmemMax - dw_fixed_bytes(ng)) / (ng * kDwBox)
             : kDwStagesMax;
}

constexpr size_t dw_smem_bytes(int ng) {
  return (size_t)dw_fixed_bytes(ng) + (size_t)dw_stages(ng) * ng * kDwBox;
}

template <int NG>
__global__ void __launch_bounds__(kDwThreads, 1)
ce_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ bias, const int* __restrict__ tgt,
                   const float* __restrict__ lse,
                   const float* __restrict__ gll, DwOut o, int M, int V,
                   int rows_per_split) {
  constexpr int dp = NG * 64;
  constexpr int kStages = dw_stages(NG);
  constexpr int kSlab = NG * kDwBox;   // an x slab: NG boxes of 64 columns
  static_assert(kStages * kSlab >= dp * 64 * 4, "dW hand-over fits the ring");
  extern __shared__ unsigned char dw_smem_raw[];
  unsigned char* smem =
      dw_smem_raw + ((1024u - (smem_u32(dw_smem_raw) & 1023u)) & 1023u);
  unsigned char* wt = smem;                     // [dp][128 B]: the W tile
  unsigned char* ring = wt + NG * 64 * 128;     // kStages x slabs
  unsigned char* dls = ring + kStages * kSlab;  // 2 x [64 rows][128 B]
  float* red = reinterpret_cast<float*>(dls + 2 * kDwBox);  // [8 warps][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * 64);
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;
  int* flag = reinterpret_cast<int*>(wbar + 1);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int tile = blockIdx.x, n0 = tile * 64;
  const int z = blockIdx.y, splits = gridDim.y;
  const int mb = z * rows_per_split;
  const int slabs = (min(M, mb + rows_per_split) - mb + kDwRows - 1) / kDwRows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 128);
    }
    mbar_init(smem_u32(wbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: the W tile, then slab i into stage i % kStages once the
    // warpgroup that took its last slab has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (t == 0) {
      mbar_arrive_expect_tx(smem_u32(wbar), NG * 64 * 128);
      tma_load_2d(smem_u32(wt), &wmap, smem_u32(wbar), n0, 0);
      for (int i = 0; i < slabs; ++i) {
        const int s = i % kStages;
        mbar_wait(smem_u32(empty + s), ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(smem_u32(full + s), kSlab);
        for (int g = 0; g < NG; ++g)
          tma_load_2d(smem_u32(ring + s * kSlab + g * kDwBox), &xmap,
                      smem_u32(full + s), g * 64, mb + i * kDwRows);
      }
    }
    return;
  }

  // a consumer: warpgroup wg takes slabs wg, wg + 2, ..; this thread's slab
  // rows rloc and rloc + 8, columns n0 + 8 j + c2 (+ 1) of each 8-column
  // block j
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int warp = t >> 5, lane = t & 31, c2 = 2 * (lane & 3);
  const int rloc = warp * 16 + (lane >> 2);
  float acc[NG][32];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
  float dbp[16];  // the db partials of this thread's 16 columns
#pragma unroll
  for (int q = 0; q < 16; ++q) dbp[q] = 0.f;
  float bv[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * j + c2 + e;
      bv[2 * j + e] = n < V ? bias[n] : 0.f;
    }
  const uint32_t wta = smem_u32(wt);
  unsigned char* dl = dls + wg * kDwBox;
  const uint32_t dla = smem_u32(dl);
  mbar_wait(smem_u32(wbar), 0);
  for (int i = wg; i < slabs; i += 2) {
    const int s = i % kStages, m0 = mb + i * kDwRows;
    float rl[2], rg[2];
    int rt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + rloc + 8 * r;
      const bool ok = m < M;
      rl[r] = ok ? lse[m] : INFINITY;  // exp(. - inf) = 0: no gradient
      rg[r] = ok ? gll[m] : 0.f;
      rt[r] = ok ? tgt[m] : -1;
    }
    mbar_wait(smem_u32(full + s), (i / kStages) & 1);
    const uint32_t xa = smem_u32(ring + s * kSlab);
    float sc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) sc[q] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < dp / 16; ++kk)  // S = x . W_tile over dp
      wgmma_m64n64_ss(sc,
                      sw128_desc(xa + (kk >> 2) * kDwBox + (kk & 3) * 32, 16),
                      sw128_desc(wta + kk * 2048, 16));
    wgmma_commit();
    wgmma_wait<0>();
    // dl = (onehot - exp(l - lse)) * gll, l = S + bias: element q of block
    // j is row rloc + 8 (q / 2), column n0 + 8 j + c2 + q % 2; the f32 value
    // into db, the bf16 one into the swizzled dl tile (the warpgroup's
    // last product from it is complete: wgmma_wait below)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + c2 + e;
          const float p = expf(sc[4 * j + 2 * r + e] + bv[2 * j + e] - rl[r]);
          v[e] = n < V ? ((n == rt[r] ? 1.f : 0.f) - p) * rg[r] : 0.f;
          dbp[2 * j + e] += v[e];
        }
        const int row = rloc + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(
            dl + row * 128 + ((j ^ (row & 7)) << 4) + c2 * 2) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    // the generic-proxy stores, visible to the tensor cores' async proxy;
    // then the warpgroup's four warps have written their rows
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (wg == 0)
      asm volatile("bar.sync 1, 128;" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;" ::: "memory");
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int kk = 0; kk < kDwRows / 16; ++kk)  // dW += x^T . dl
        wgmma_m64n64_tt(acc[g], sw128_desc(xa + g * kDwBox + kk * 2048,
                                           kDwBox),
                        sw128_desc(dla + kk * 2048, kDwBox));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(smem_u32(empty + s));
  }

  // every slab is consumed: the ring holds warpgroup 1's dW tile for
  // warpgroup 0 (thread order, so the stores and loads are conflict-free),
  // and the db rows: each warp's 8 lane rows added by shuffles, then the 8
  // consumer warps in order
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      dbp[q] += __shfl_xor_sync(0xffffffffu, dbp[q], off);
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(wg * 4 + warp) * 64 + 8 * j + c2 + e] = dbp[2 * j + e];
  asm volatile("bar.sync 3, 256;" ::: "memory");
  float* hand = reinterpret_cast<float*>(ring);
  if (wg == 1)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int q = 0; q < 32; ++q) hand[(g * 32 + q) * 128 + t] = acc[g][q];
  asm volatile("bar.sync 3, 256;" ::: "memory");
  const size_t part = (size_t)tile * splits + z;
  if (wg == 0) {
    float* dst = o.ws + part * dp * 64;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = 4 * j + 2 * r;
          *reinterpret_cast<float2*>(
              dst + (g * 64 + rloc + 8 * r) * 64 + 8 * j + c2) =
              make_float2(acc[g][q] + hand[(g * 32 + q) * 128 + t],
                          acc[g][q + 1] + hand[(g * 32 + q + 1) * 128 + t]);
        }
    if (t < 64) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w * 64 + t];
      o.ws_db[part * 64 + t] = sum;
    }
  }
  if (split_last_block<3, 256>(o.counters + tile, splits, flag))
    split_reduce<dp, 64>(o.ws + (size_t)tile * splits * dp * 64, splits,
                         o.dw, o.K, o.N, 0, n0,
                         o.ws_db + (size_t)tile * splits * 64, o.db, 256);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// bf16: x (M, dp) and w (dp, Vp) 16-byte aligned, their tensor maps
// encoded per call; `blocks` blocks of 128 rows and `smem` bytes, each with
// a ring of `stages` W tiles (ops/token_ce.py::fwd_plan)
template <int NG>
int launch_fwd_wgmma(const void* x, const void* w, const float* bias,
                     const int* tgt, float* ll, float* corr, float* lse,
                     int M, int V, int Vp, int blocks, int stages, int smem,
                     cudaStream_t stream) {
  constexpr int dp = NG * 64;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (long long)blocks * kDxRows < M || stages < 2 || smem > kSmemMax ||
      (size_t)smem < fwd_smem_bytes(dp, stages))
    return (int)cudaErrorInvalidValue;
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  if (!tmap_2d(&xmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, dp,
               64, kDxRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_2d(&wmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dp, Vp,
               64, dp, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_smem(ce_fwd_wgmma_kernel<NG>, smem);
  if (err != cudaSuccess) return (int)err;
  ce_fwd_wgmma_kernel<NG><<<blocks, kDxThreads, smem, stream>>>(
      xmap, wmap, bias, tgt, ll, corr, lse, M, V, stages);
  return (int)cudaGetLastError();
}

// f32: ce_fwd_kernel
int launch_fwd_f32(const void* x, const void* w, const void* bias,
                   const void* tgt, void* ll, void* corr, void* lse, int M,
                   int dp, int V, int Vp, cudaStream_t stream) {
  const size_t smem = smem_bytes(dp);
  cudaError_t err = set_smem(ce_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ce_fwd_kernel<<<(M + BM - 1) / BM, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(tgt),
      static_cast<float*>(ll), static_cast<float*>(corr),
      static_cast<float*>(lse), M, dp, V, Vp);
  return (int)cudaGetLastError();
}

// bf16 dx and dW: x (M, dp) and w (dp, Vp) 16-byte aligned, their tensor
// maps encoded per call (x in 128-row boxes for dx, 64-row for dW; one W
// map of dp-row tiles for both)
template <int NG>
int launch_bwd_wgmma(const void* x, const void* w, const float* bias,
                     const int* tgt, const float* lse, const float* gll,
                     void* dx, const DwOut& o, int M, int V, int Vp,
                     int splits, int rows_per_split, cudaStream_t stream) {
  constexpr int dp = NG * 64;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, xmap_dw, wmap;
  if (!tmap_2d(&xmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, dp,
               64, kDxRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_2d(&xmap_dw, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M,
               dp, 64, kDwRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_2d(&wmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dp, Vp,
               64, dp, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(ce_dx_wgmma_kernel<NG>, dx_smem_bytes(dp));
  if (err != cudaSuccess) return (int)err;
  ce_dx_wgmma_kernel<NG><<<(M + kDxRows - 1) / kDxRows, kDxThreads,
                           dx_smem_bytes(dp), stream>>>(
      xmap, wmap, bias, tgt, lse, gll, static_cast<__nv_bfloat16*>(dx), M, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_smem(ce_dw_wgmma_kernel<NG>, dw_smem_bytes(NG));
  if (err != cudaSuccess) return (int)err;
  ce_dw_wgmma_kernel<NG><<<dim3(Vp / 64, splits), kDwThreads,
                           dw_smem_bytes(NG), stream>>>(
      xmap_dw, wmap, bias, tgt, lse, gll, o, M, V, rows_per_split);
  return (int)cudaGetLastError();
}

// f32: dx (ce_dx_kernel), then dW and db (ce_dw_kernel)
template <int NG>
int launch_bwd_f32(const void* x, const void* w, const void* bias,
                   const void* tgt, const void* lse, const void* gll, void* dx,
                   const DwOut& o, int M, int dp, int V, int Vp, int splits,
                   int rows_per_split, cudaStream_t stream) {
  const float* bp = static_cast<const float*>(bias);
  const int* tp = static_cast<const int*>(tgt);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(gll);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const size_t smem = smem_bytes(dp);
  cudaError_t err = set_smem(ce_dx_kernel<NG>, smem);
  if (err != cudaSuccess) return (int)err;
  ce_dx_kernel<NG><<<(M + BM - 1) / BM, kThreads, smem, stream>>>(
      xp, wp, bp, tp, lp, gp, static_cast<float*>(dx), M, dp, V, Vp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_smem(ce_dw_kernel<NG>, smem);
  if (err != cudaSuccess) return (int)err;
  ce_dw_kernel<NG><<<dim3(Vp / BN, splits), kThreads, smem, stream>>>(
      xp, wp, bp, tp, lp, gp, o, M, dp, V, Vp, rows_per_split);
  return (int)cudaGetLastError();
}

bool shapes_ok(int M, int dp, int V, int Vp) {
  return M > 0 && dp > 0 && dp % BM == 0 && dp <= 4 * BM && V > 0 &&
         Vp % BN == 0 && V <= Vp;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x (M, dp) and w (dp, Vp) in the
// compute dtype, zero-padded to dp and Vp (multiples of 64, dp <= 256);
// bias (V,) f32; tgt (M,) int32; ll / corr / lse / gll (M,) f32.
extern "C" {

int sk_token_ce_fwd(int dtype, const void* x, const void* w, const void* bias,
                    const void* tgt, void* ll, void* corr, void* lse, int M,
                    int dp, int V, int Vp, int blocks, int stages, int smem,
                    void* stream) {
  if (!shapes_ok(M, dp, V, Vp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_f32(x, w, bias, tgt, ll, corr, lse, M, dp, V, Vp, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define SK_FWD(NG)                                                          \
  case NG:                                                                  \
    return launch_fwd_wgmma<NG>(                                            \
        x, w, static_cast<const float*>(bias), static_cast<const int*>(tgt), \
        static_cast<float*>(ll), static_cast<float*>(corr),                 \
        static_cast<float*>(lse), M, V, Vp, blocks, stages, smem, s)
  switch (dp / BM) {
    SK_FWD(1);
    SK_FWD(2);
    SK_FWD(3);
    SK_FWD(4);
  }
#undef SK_FWD
  return (int)cudaErrorInvalidValue;
}

// dx (M, dp) in the compute dtype; dw (d, V) and db (V) f32, summed over
// `splits` M slices of rows_per_split rows (a multiple of 64) whose
// partials go to ws (tiles, splits, dp, 64) and ws_db
// (tiles, splits, 64), with one zeroed counter a 64-column vocab tile
int sk_token_ce_bwd(int dtype, const void* x, const void* w, const void* bias,
                    const void* tgt, const void* lse, const void* gll,
                    void* dx, void* dw, void* db, void* ws, void* ws_db,
                    void* counters, int M, int d, int dp, int V, int Vp,
                    int splits, int rows_per_split, void* stream) {
  static_assert(kDwRows == BM, "one split unit in both dtypes");
  if (!shapes_ok(M, dp, V, Vp) || d < 1 || d > dp || splits < 1 ||
      rows_per_split % BM != 0 ||
      (long long)splits * rows_per_split < M ||
      (long long)(splits - 1) * rows_per_split >= M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DwOut o;
  o.dw = static_cast<float*>(dw);
  o.db = static_cast<float*>(db);
  o.ws = static_cast<float*>(ws);
  o.ws_db = static_cast<float*>(ws_db);
  o.counters = static_cast<unsigned*>(counters);
  o.K = d;
  o.N = V;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
#define SK_BWD(NG)                                                          \
  case NG:                                                                  \
    return dtype == 0                                                       \
               ? launch_bwd_f32<NG>(x, w, bias, tgt, lse, gll, dx, o, M, dp, \
                                    V, Vp, splits, rows_per_split, s)       \
               : launch_bwd_wgmma<NG>(                                      \
                     x, w, static_cast<const float*>(bias),                 \
                     static_cast<const int*>(tgt),                          \
                     static_cast<const float*>(lse),                        \
                     static_cast<const float*>(gll), dx, o, M, V, Vp,       \
                     splits, rows_per_split, s)
  switch (dp / BM) {
    SK_BWD(1);
    SK_BWD(2);
    SK_BWD(3);
    SK_BWD(4);
  }
#undef SK_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
