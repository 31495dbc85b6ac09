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
//           partials that sum_rows (norm_train.cu) adds in a fixed order.
//
// Design. A block owns a 64-row tile (forward and dx) or a 64-column vocab
// tile and an M slice (dW). The operand it keeps (the rows, or the W tile)
// stays in shared memory while it streams the other; each 64 x 64 logits
// tile is a WMMA product (bf16 in, f32 accumulate; f32 inputs on the FMA
// units) into shared memory and is reduced there on the spot: the forward
// keeps a running max, sum of exponentials, target logit and first argmax
// per row (four threads a row, combined at the end); the backward turns the
// tile into dl and multiplies it out. No atomics: every sum has a fixed
// order, so re-runs are bit-stable. Each backward kernel recomputes the
// logits from (x, W, b) instead of reading them; the TPU kernel recomputes
// once and does both products, so the dW kernel's recompute is work the
// TPU design does not do.
//
// The wrapper (ops/token_ce.py) pads d and V to multiples of 64 (zero
// rows and columns of W; columns >= V are excluded here by index, as the
// JAX kernel's NEG_INF bias padding does on the TPU's 128 lanes).
//
// What bounds it on the card: the products, 2 M d V operations for the
// forward and 3 x that for the backward (recompute, dx, dW). At d = 256 a
// row tile does 2 * 64 * 256 operations per W element it stages, so the
// tiles are tensor-core bound only with a well-fed pipeline; this first
// landing stages synchronously (no TMA, no wgmma, no double buffering).
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <mma.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 16 x 32
constexpr int BM = 64;         // rows of a tile
constexpr int BN = 64;         // vocab columns of a tile
constexpr int kPad = 8;        // shared-memory row pad (elements)
constexpr int kLdc = BN + 4;   // f32 logits tile row stride

using FragC =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

template <typename T>
constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
__device__ __forceinline__ void zero_tile(FragC (&cf)[2], float (&acc)[4][4]) {
  if constexpr (kTC<T>) {
    nvcuda::wmma::fill_fragment(cf[0], 0.f);
    nvcuda::wmma::fill_fragment(cf[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// one 64 x 64 f32 tile += A (64 x K) . B (K x 64), both in shared memory:
// A(i, k) = as[i * lda + k] (kAT: as[k * lda + i]), B(k, j) = bs[k * ldb + j]
// (kBT: bs[j * ldb + k]). bf16: each warp a 16 x 32 strip of WMMA
// fragments; f32: each thread a 4 x 4 register tile strided by 16.
template <typename T, bool kAT, bool kBT>
__device__ __forceinline__ void mma_tile(const T* as, int lda, const T* bs,
                                         int ldb, int K, FragC (&cf)[2],
                                         float (&acc)[4][4], int tid) {
  using namespace nvcuda;
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int ty = tid >> 4, tx = tid & 15;
  if constexpr (kTC<T>) {
    using LA = std::conditional_t<kAT, wmma::col_major, wmma::row_major>;
    using LB = std::conditional_t<kBT, wmma::col_major, wmma::row_major>;
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
      wmma::load_matrix_sync(
          fa, kAT ? &as[kk * lda + wm * 16] : &as[wm * 16 * lda + kk], lda);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int c = wn * 32 + f * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
        wmma::load_matrix_sync(fb, kBT ? &bs[c * ldb + kk] : &bs[kk * ldb + c],
                               ldb);
        wmma::mma_sync(cf[f], fa, fb, cf[f]);
      }
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        av[i] = to_f<T>(kAT ? as[kk * lda + r] : as[r * lda + kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bv[j] = to_f<T>(kBT ? bs[c * ldb + kk] : bs[kk * ldb + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// the 64 x 64 tile into shared memory, row stride kLdc
template <typename T>
__device__ __forceinline__ void store_tile(float* cs, FragC (&cf)[2],
                                           float (&acc)[4][4], int tid) {
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int ty = tid >> 4, tx = tid & 15;
  if constexpr (kTC<T>) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
      nvcuda::wmma::store_matrix_sync(&cs[wm * 16 * kLdc + wn * 32 + f * 16],
                                      cf[f], kLdc,
                                      nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cs[(ty + 16 * i) * kLdc + tx + 16 * j] = acc[i][j];
  }
}

// rows x cols of T (cols a multiple of the 16-byte vector, src rows 16-byte
// aligned) from device memory into shared memory; rows >= valid are zeros
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src,
                                      size_t lds, int rows, int cols,
                                      int valid, int tid) {
  constexpr int VW = 16 / sizeof(T);
  const int per_row = cols / VW;
  for (int v = tid; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v - r * per_row) * VW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

// shared-memory layout of all three kernels (every part a multiple of 128
// bytes): xs [BM][dp + kPad] rows, ws [dp][BN + kPad] a W tile, cs [BM][kLdc]
// f32 logits, ds [BM][BN + kPad] dl in the compute dtype, then per-row
// (lse, gll, tgt) and the db reduction rows
template <typename T>
struct Smem {
  static size_t bytes(int dp) {
    return sizeof(T) * ((size_t)BM * (dp + kPad) + (size_t)dp * (BN + kPad) +
                        (size_t)BM * (BN + kPad)) +
           sizeof(float) * ((size_t)BM * kLdc + 3 * BM + 4 * BN);
  }
};

template <typename T>
struct Parts {
  T *xs, *ws, *ds;
  float *cs, *rl, *rg, *red;
  int* rt;
  __device__ Parts(unsigned char* base, int dp) {
    xs = reinterpret_cast<T*>(base);
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
template <typename T>
__device__ __forceinline__ void logits_tile(const Parts<T>& s, int dp,
                                            int tid) {
  FragC cf[2];
  float acc[4][4];
  zero_tile<T>(cf, acc);
  mma_tile<T, false, false>(s.xs, dp + kPad, s.ws, BN + kPad, dp, cf, acc,
                            tid);
  store_tile<T>(s.cs, cf, acc, tid);
  __syncthreads();
}

// the row statistics of the backward for rows m0 .. m0+63 (rows >= M get a
// zero gradient)
template <typename T>
__device__ __forceinline__ void load_rows(const Parts<T>& s,
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
template <typename T>
__device__ __forceinline__ float dlogit(const Parts<T>& s,
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, const int* __restrict__ tgt,
              float* __restrict__ ll, float* __restrict__ corr,
              float* __restrict__ lse, int M, int dp, int V, int Vp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Parts<T> s(smem, dp);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  stage<T>(s.xs, dp + kPad, x + (size_t)m0 * dp, dp, BM, dp, M - m0, tid);
  // four threads a row, each a quarter of every tile's columns
  const int r = tid >> 2, q = tid & 3, m = m0 + r;
  const int tg = m < M ? tgt[m] : -1;
  float rmax = -INFINITY, rsum = 0.f, tl = 0.f, bval = -INFINITY;
  int bidx = INT_MAX;
  for (int n0 = 0; n0 < V; n0 += BN) {
    __syncthreads();  // the previous tile's reads of ws and cs are done
    stage<T>(s.ws, BN + kPad, w + n0, Vp, dp, BN, dp, tid);
    __syncthreads();
    logits_tile<T>(s, dp, tid);
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

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
ce_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ gll,
             T* __restrict__ dx, int M, int dp, int V, int Vp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Parts<T> s(smem, dp);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  stage<T>(s.xs, dp + kPad, x + (size_t)m0 * dp, dp, BM, dp, M - m0, tid);
  load_rows<T>(s, tgt, lse, gll, m0, M, tid);
  FragC cf[NG][2];
  float acc[NG][4][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) zero_tile<T>(cf[g], acc[g]);
  for (int n0 = 0; n0 < V; n0 += BN) {
    __syncthreads();
    stage<T>(s.ws, BN + kPad, w + n0, Vp, dp, BN, dp, tid);
    __syncthreads();
    logits_tile<T>(s, dp, tid);
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e - r * BN;
      s.ds[r * (BN + kPad) + c] = from_f<T>(dlogit<T>(s, bias, r, c, n0, V));
    }
    __syncthreads();
    // dx[:, g*64 ..] += dl (64 x 64) . W[g*64 .., n0 ..]^T
#pragma unroll
    for (int g = 0; g < NG; ++g)
      mma_tile<T, false, true>(s.ds, BN + kPad, s.ws + g * BM * (BN + kPad),
                               BN + kPad, BN, cf[g], acc[g], tid);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    __syncthreads();
    store_tile<T>(s.cs, cf[g], acc[g], tid);
    __syncthreads();
    for (int e = tid; e < BM * BM; e += kThreads) {
      const int r = e / BM, c = e - r * BM;
      if (m0 + r < M)
        dx[(size_t)(m0 + r) * dp + g * BM + c] = from_f<T>(s.cs[r * kLdc + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dW and db: one block per (64-column vocab tile, M slice); the W
// tile stays in shared memory while the slice's row tiles stream through
// ---------------------------------------------------------------------------

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ gll,
             float* __restrict__ dw_part, float* __restrict__ db_part, int M,
             int dp, int V, int Vp, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Parts<T> s(smem, dp);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, z = blockIdx.y;
  const int mb = z * rows_per_split, me = min(M, mb + rows_per_split);
  stage<T>(s.ws, BN + kPad, w + n0, Vp, dp, BN, dp, tid);
  FragC cf[NG][2];
  float acc[NG][4][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) zero_tile<T>(cf[g], acc[g]);
  const int c = tid % BN, r_first = tid / BN;  // this thread's dl column
  float db = 0.f;
  for (int m0 = mb; m0 < me; m0 += BM) {
    __syncthreads();
    stage<T>(s.xs, dp + kPad, x + (size_t)m0 * dp, dp, BM, dp, me - m0, tid);
    load_rows<T>(s, tgt, lse, gll, m0, me, tid);
    __syncthreads();
    logits_tile<T>(s, dp, tid);
    for (int r = r_first; r < BM; r += kThreads / BN) {
      const float dl = dlogit<T>(s, bias, r, c, n0, V);
      db += dl;
      s.ds[r * (BN + kPad) + c] = from_f<T>(dl);
    }
    __syncthreads();
    // dW[g*64 .., n0 ..] += x[m0 .., g*64 ..]^T . dl
#pragma unroll
    for (int g = 0; g < NG; ++g)
      mma_tile<T, true, false>(s.xs + g * BM, dp + kPad, s.ds, BN + kPad, BM,
                               cf[g], acc[g], tid);
  }
  float* dst = dw_part + (size_t)z * dp * Vp;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    __syncthreads();
    store_tile<T>(s.cs, cf[g], acc[g], tid);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, cc = e - r * BN;
      dst[(size_t)(g * BM + r) * Vp + n0 + cc] = s.cs[r * kLdc + cc];
    }
  }
  // db: the four threads of a column, added in a fixed order
  s.red[r_first * BN + c] = db;
  __syncthreads();
  if (tid < BN) {
    float t = 0.f;
    for (int i = 0; i < kThreads / BN; ++i) t += s.red[i * BN + tid];
    db_part[(size_t)z * Vp + n0 + tid] = t;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* bias,
               const void* tgt, void* ll, void* corr, void* lse, int M, int dp,
               int V, int Vp, cudaStream_t stream) {
  const size_t smem = Smem<T>::bytes(dp);
  cudaError_t err = set_smem(ce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ce_fwd_kernel<T><<<(M + BM - 1) / BM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(tgt),
      static_cast<float*>(ll), static_cast<float*>(corr),
      static_cast<float*>(lse), M, dp, V, Vp);
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int launch_bwd_ng(const void* x, const void* w, const void* bias,
                  const void* tgt, const void* lse, const void* gll, void* dx,
                  void* dw_part, void* db_part, int M, int dp, int V, int Vp,
                  int splits, cudaStream_t stream) {
  const size_t smem = Smem<T>::bytes(dp);
  cudaError_t err = set_smem(ce_dx_kernel<T, NG>, smem);
  if (err == cudaSuccess) err = set_smem(ce_dw_kernel<T, NG>, smem);
  if (err != cudaSuccess) return (int)err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(bias);
  const int* tp = static_cast<const int*>(tgt);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(gll);
  ce_dx_kernel<T, NG><<<(M + BM - 1) / BM, kThreads, smem, stream>>>(
      xp, wp, bp, tp, lp, gp, static_cast<T*>(dx), M, dp, V, Vp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rps = ((M + splits - 1) / splits + BM - 1) / BM * BM;
  ce_dw_kernel<T, NG><<<dim3(Vp / BN, splits), kThreads, smem, stream>>>(
      xp, wp, bp, tp, lp, gp, static_cast<float*>(dw_part),
      static_cast<float*>(db_part), M, dp, V, Vp, rps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* bias, const void* tgt,
               const void* lse, const void* gll, void* dx, void* dw_part,
               void* db_part, int M, int dp, int V, int Vp, int splits,
               cudaStream_t stream) {
  switch (dp / BM) {
    case 1:
      return launch_bwd_ng<T, 1>(x, w, bias, tgt, lse, gll, dx, dw_part,
                                 db_part, M, dp, V, Vp, splits, stream);
    case 2:
      return launch_bwd_ng<T, 2>(x, w, bias, tgt, lse, gll, dx, dw_part,
                                 db_part, M, dp, V, Vp, splits, stream);
    case 3:
      return launch_bwd_ng<T, 3>(x, w, bias, tgt, lse, gll, dx, dw_part,
                                 db_part, M, dp, V, Vp, splits, stream);
    case 4:
      return launch_bwd_ng<T, 4>(x, w, bias, tgt, lse, gll, dx, dw_part,
                                 db_part, M, dp, V, Vp, splits, stream);
  }
  return (int)cudaErrorInvalidValue;
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
                    int dp, int V, int Vp, void* stream) {
  if (!shapes_ok(M, dp, V, Vp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, w, bias, tgt, ll, corr, lse, M, dp, V, Vp, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, bias, tgt, ll, corr, lse, M, dp, V,
                                     Vp, s);
  return (int)cudaErrorInvalidValue;
}

// dx (M, dp) in the compute dtype; dw_part (splits, dp, Vp) and db_part
// (splits, Vp) f32 partial sums over M slices
int sk_token_ce_bwd(int dtype, const void* x, const void* w, const void* bias,
                    const void* tgt, const void* lse, const void* gll,
                    void* dx, void* dw_part, void* db_part, int M, int dp,
                    int V, int Vp, int splits, void* stream) {
  if (!shapes_ok(M, dp, V, Vp) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, w, bias, tgt, lse, gll, dx, dw_part, db_part,
                             M, dp, V, Vp, splits, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, bias, tgt, lse, gll, dx, dw_part,
                                     db_part, M, dp, V, Vp, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
