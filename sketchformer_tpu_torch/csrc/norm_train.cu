// Hopper (sm_90a) kernels for the LayerNorm backward and the fixed-order
// reductions of the training stacks.
//
// Replaces, inside sketchformer_tpu/ops/pallas_encoder_train.py::
// _layer_bwd_kernel and sketchformer_tpu/ops/pallas_decoder_train.py::
// _dec_layer_bwd_kernel, the LayerNorm backward (_ln_bwd32) with its
// residual add, and the accumulation of the LayerNorm parameter gradients
// across grid cells (acc: the TPU kernels revisit one output block across a
// sequential grid). Blocks here run in parallel, so each writes one partial
// row and the partial rows are added in a fixed order in the same launch
// (layernorm_bwd: scratch and its last block, split_reduce.cuh; sum_rows:
// a cluster's shared memory): one launch a call, and re-runs are
// bit-stable.
//
//   layernorm_bwd  a grid sized to the card (ops/norm_train.py::ln_bwd_plan:
//                  up to one block of 16 warps an SM); each warp walks the
//                  rows gw, gw + G, gw + 2G, ... (gw its index in the grid,
//                  G the grid's warps), one row at a time held in registers:
//                  at D = 32 * C (C = 4 or 8) each lane owns C contiguous
//                  columns and reads x, dy and the residual with 8- or
//                  16-byte loads, once. The row's f32 statistics (var =
//                  max(E[x^2] - mu^2, 0), eps 1e-6, as the forward), m1 =
//                  mean(dxhat) and m2 = mean(dxhat * xhat) come from warp
//                  shuffles; dx = rstd * (dxhat - m1 - xhat * m2) (+ the
//                  residual gradient) is written in f32 or the compute dtype
//                  with vector stores. Each lane keeps its columns' sums of
//                  dy * xhat and dy in registers over its rows; the block
//                  adds its warps in order through shared memory and writes
//                  one partial row; the last block adds the blocks' rows in
//                  a fixed order (split_reduce_row_parts: runs of
//                  consecutive blocks, then the runs) into dscale and
//                  dbias. Other widths take a column
//                  loop in the same kernel (lane c, c + 32, ...; the row
//                  read from global memory per pass, the sums in shared
//                  memory). At D = 32 * C a lane loads its columns of
//                  scale once, not once a row.
//   sum_rows       out[c] = sum over rows r of x[r, c]: lanes over columns
//                  with 16-byte loads (4 f32 or 8 bf16 columns a lane) in
//                  narrow column tiles (ops/norm_train.py::sum_rows_plan:
//                  at least 8 tiles, at most 256 KB of input a block), so
//                  a warp reads 32 / lanes rows at once and a narrow N
//                  still spreads over many SMs; each tile's rows are cut
//                  into the slices of one thread block cluster (up to 8
//                  blocks); a fixed butterfly adds a warp's row groups, a
//                  fixed-order pass the block's warps, and the cluster's
//                  first block gathers the slices' partial rows over
//                  distributed shared memory and adds them in order: no
//                  scratch, no counter, no fence through global memory.
//                  The f32 attention backward's qk-norm partial rows come
//                  here (attention_train.cu); the bias gradients are
//                  linear_tn's (encoder_stack.cu).
//
// Both are bound by memory: each reads its operands once and writes its
// outputs once (layernorm_bwd's partial rows are a few hundred KB, read
// back from L2; sum_rows' stay in shared memory).
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "split_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLnMaxThreads = 512;  // 16 warps, one block an SM
constexpr int kSumMaxThreads = 1024;

// n contiguous values of T at p (aligned to the whole span's widest load)
// as f32
template <int n, typename T>
__device__ __forceinline__ void load_f(const T* __restrict__ p,
                                       float (&v)[n]) {
  constexpr int bytes = n * (int)sizeof(T);
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < bytes / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < 16 / (int)sizeof(T); ++j)
        v[i * (16 / sizeof(T)) + j] = to_f<T>(e[j]);
    }
  } else {
    static_assert(bytes % 8 == 0, "load_f: 8-byte spans at least");
#pragma unroll
    for (int i = 0; i < bytes / 8; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < 8 / (int)sizeof(T); ++j)
        v[i * (8 / sizeof(T)) + j] = to_f<T>(e[j]);
    }
  }
}

template <int n, typename T>
__device__ __forceinline__ void store_f(T* __restrict__ p,
                                        const float (&v)[n]) {
  constexpr int bytes = n * (int)sizeof(T);
  constexpr int w = bytes % 16 == 0 ? 16 : 8;
  static_assert(bytes % 8 == 0, "store_f: 8-byte spans at least");
#pragma unroll
  for (int i = 0; i < bytes / w; ++i) {
    alignas(w) T e[w / sizeof(T)];
#pragma unroll
    for (int j = 0; j < w / (int)sizeof(T); ++j)
      e[j] = from_f<T>(v[i * (w / sizeof(T)) + j]);
    if constexpr (w == 16)
      reinterpret_cast<uint4*>(p)[i] = *reinterpret_cast<const uint4*>(e);
    else
      reinterpret_cast<uint2*>(p)[i] = *reinterpret_cast<const uint2*>(e);
  }
}

// C columns a lane (D = 32 * C), or C = 0: any D, a column loop. Dynamic
// shared memory: red [warps][2 * D] (each warp's sums of dy * xhat, then of
// dy). Partial rows go to ws [gridDim.x][2 * D]; the last
// block writes grads [2][D] (dscale, then dbias).
template <typename T, typename TR, typename TO, int C>
__global__ void __launch_bounds__(kLnMaxThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ scale,
                     const TR* __restrict__ resid, TO* __restrict__ dx,
                     float* __restrict__ grads, float* __restrict__ ws,
                     unsigned* __restrict__ counter, int M, int D) {
  extern __shared__ __align__(16) float red[];
  __shared__ int flag;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws_w = red + (size_t)warp * 2 * D;  // this warp's sums
  const int stride = gridDim.x * warps;
  if constexpr (C > 0) {
    const int c0 = lane * C;
    float sc[C], ds[C], db[C];
    load_f<C>(scale + c0, sc);
#pragma unroll
    for (int j = 0; j < C; ++j) ds[j] = db[j] = 0.f;
    for (int m = blockIdx.x * warps + warp; m < M; m += stride) {
      const size_t off = (size_t)m * D + c0;
      float xv[C], g[C], r[C];
      load_f<C>(x + off, xv);
      load_f<C>(dy + off, g);
      if (resid != nullptr) load_f<C>(resid + off, r);
      float sum = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        sum += xv[j];
        ss += xv[j] * xv[j];
      }
      sum = warp_sum(sum);
      ss = warp_sum(ss);
      const float mu = sum / D;
      const float rstd =
          1.f / sqrtf(fmaxf(ss / D - mu * mu, 0.f) + kLnEps);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        xv[j] = (xv[j] - mu) * rstd;  // xhat
        const float dxh = g[j] * sc[j];
        m1 += dxh;
        m2 += dxh * xv[j];
        ds[j] += g[j] * xv[j];
        db[j] += g[j];
      }
      m1 = warp_sum(m1) / D;
      m2 = warp_sum(m2) / D;
      float out[C];
#pragma unroll
      for (int j = 0; j < C; ++j)
        out[j] = rstd * (g[j] * sc[j] - m1 - xv[j] * m2);
      if (resid != nullptr) {
#pragma unroll
        for (int j = 0; j < C; ++j) out[j] = r[j] + out[j];
      }
      store_f<C>(dx + off, out);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      ws_w[c0 + j] = ds[j];
      ws_w[D + c0 + j] = db[j];
    }
  } else {
    for (int c = lane; c < 2 * D; c += 32) ws_w[c] = 0.f;
    for (int m = blockIdx.x * warps + warp; m < M; m += stride) {
      const T* xr = x + (size_t)m * D;
      const float* gr = dy + (size_t)m * D;
      float sum = 0.f, ss = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float v = to_f<T>(xr[c]);
        sum += v;
        ss += v * v;
      }
      sum = warp_sum(sum);
      ss = warp_sum(ss);
      const float mu = sum / D;
      const float rstd =
          1.f / sqrtf(fmaxf(ss / D - mu * mu, 0.f) + kLnEps);
      float m1 = 0.f, m2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float xh = (to_f<T>(xr[c]) - mu) * rstd;
        const float g = gr[c], dxh = g * scale[c];
        m1 += dxh;
        m2 += dxh * xh;
        ws_w[c] += g * xh;
        ws_w[D + c] += g;
      }
      m1 = warp_sum(m1) / D;
      m2 = warp_sum(m2) / D;
      for (int c = lane; c < D; c += 32) {
        const float xh = (to_f<T>(xr[c]) - mu) * rstd;
        float v = rstd * (gr[c] * scale[c] - m1 - xh * m2);
        if (resid != nullptr) v = to_f<TR>(resid[(size_t)m * D + c]) + v;
        dx[(size_t)m * D + c] = from_f<TO>(v);
      }
    }
  }
  __syncthreads();
  // the block's partial row: its warps added in order
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < warps; ++w) a += red[(size_t)w * 2 * D + c];
    ws[(size_t)blockIdx.x * 2 * D + c] = a;
  }
  if (split_last_block(counter, gridDim.x, &flag))
    split_reduce_row_parts(ws, gridDim.x, 2 * (size_t)D, grads, 2 * D, red,
                           warps * 2 * D);
}

// Columns in tiles of L lanes x V (V = 16 bytes of TI, L a power of two up
// to 32): a warp reads 32 / L rows at once, lane l row group l / L. Block
// (x, y) covers column tile x and the row slice [y * rows_per_block, ...);
// the gridDim.y blocks of a column tile form one cluster. Each block adds
// its warps' sums into a partial row in its shared memory; block 0 of the
// cluster gathers the partial rows over distributed shared memory and
// adds them in order y = 0, 1, ... vec: N % V == 0 and x 16-byte aligned.
// Dynamic shared memory: (warps + 1 + gridDim.y) * L * V f32.
template <typename TI, int L>
__global__ void __launch_bounds__(kSumMaxThreads)
sum_rows_kernel(const TI* __restrict__ x, float* __restrict__ out, int R,
                int N, int rows_per_block, int vec) {
  constexpr int V = 16 / sizeof(TI);
  constexpr int TW = L * V;
  constexpr int G = 32 / L;  // rows a warp reads at once
  extern __shared__ __align__(16) float red[];  // [warps][TW]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * TW;
  const int c0 = t0 + (lane % L) * V;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  const int step = warps * G;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (vec && c0 < N) {
#pragma unroll 8
    for (int r = r0 + warp * G + lane / L; r < r1; r += step) {
      float v[V];
      load_f<V>(x + (size_t)r * N + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += v[j];
    }
  } else if (!vec) {
    for (int r = r0 + warp * G + lane / L; r < r1; r += step)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c0 + j < N) acc[j] += to_f<TI>(x[(size_t)r * N + c0 + j]);
  }
  // the warp's row groups, in a fixed butterfly
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (lane < L) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp * TW + lane * V + j] = acc[j];
  }
  __syncthreads();
  const int n = min(TW, N - t0);
  float* prow = red + warps * TW;  // this block's partial row
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * TW + c];
    prow[c] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial row written
  if (cluster.block_rank() == 0) {
    const int C = (int)cluster.num_blocks();
    float* gat = prow + TW;  // [C][n]: the cluster's partial rows
    for (int t = threadIdx.x; t < C * n; t += blockDim.x)
      gat[t] = cluster.map_shared_rank(prow, t / n)[t % n];
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float s = 0.f;
      for (int z = 0; z < C; ++z) s += gat[z * n + c];
      out[t0 + c] = s;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its row
}

template <typename T>
int launch_ln_bwd(int resid_code, int out_f32, const void* x, const void* dy,
                  const void* scale, const void* resid, void* dx, void* grads,
                  void* ws, void* counter, int M, int D, int blocks,
                  int warps, int cols, cudaStream_t stream) {
  if (blocks < 1 || warps < 1 || warps * 32 > kLnMaxThreads ||
      (cols != 0 && cols * 32 != D))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)warps * D;
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(dy);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(grads);
  float* wp = static_cast<float*>(ws);
  unsigned* cp = static_cast<unsigned*>(counter);
#define SK_LN(TR, TO, COLS)                                                  \
  {                                                                          \
    auto k = layernorm_bwd_kernel<T, TR, TO, COLS>;                          \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);          \
    if (e != cudaSuccess) return (int)e;                                     \
    k<<<blocks, warps * 32, smem, stream>>>(                                 \
        xp, gp, sp, static_cast<const TR*>(resid), static_cast<TO*>(dx), op, \
        wp, cp, M, D);                                                       \
  }
#define SK_LN_COLS(TR, TO)          \
  if (cols == 8) SK_LN(TR, TO, 8)   \
  else if (cols == 4) SK_LN(TR, TO, 4) \
  else if (cols == 0) SK_LN(TR, TO, 0) \
  else return (int)cudaErrorInvalidValue;
  // resid_code: 0 f32 residual (or none), 1 residual in the compute dtype
  if (resid_code == 0 && out_f32) {
    SK_LN_COLS(float, float)
  } else if (resid_code == 0) {
    SK_LN_COLS(float, T)
  } else if (out_f32) {
    SK_LN_COLS(T, float)
  } else {
    SK_LN_COLS(T, T)
  }
#undef SK_LN_COLS
#undef SK_LN
  return (int)cudaGetLastError();
}

template <typename TI>
int launch_sum_rows(const void* x, void* out, int R, int N, int lanes,
                    int warps, int cluster, int rows_per_block, int vec,
                    cudaStream_t stream) {
  if (cluster < 1 || cluster > 8 || rows_per_block < 0 || warps < 1 ||
      warps * 32 > kSumMaxThreads)
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / (int)sizeof(TI);
  const TI* xp = static_cast<const TI*>(x);
  float* op = static_cast<float*>(out);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(warps * 32);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define SK_SUM(L)                                                         \
  if (lanes == L) {                                                       \
    cfg.gridDim = dim3((N + L * V - 1) / (L * V), cluster);               \
    cfg.dynamicSmemBytes = sizeof(float) * (warps + 1 + cluster) * L * V; \
    const cudaError_t e = cudaLaunchKernelEx(&cfg, sum_rows_kernel<TI, L>, \
                                             xp, op, R, N, rows_per_block, \
                                             vec);                        \
    if (e != cudaSuccess) return (int)e;                                  \
    return (int)cudaGetLastError();                                       \
  }
  SK_SUM(1) SK_SUM(2) SK_SUM(4) SK_SUM(8) SK_SUM(16) SK_SUM(32)
#undef SK_SUM
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" {

// grads: (2, D) f32, dscale then dbias; ws: blocks * 2 * D f32 of scratch;
// counter: one zeroed counter (the last block resets it); blocks, warps
// (a block) and cols (columns a lane, 4 or 8 with D = 32 * cols and every
// row operand 16-byte aligned, else 0) from ops/norm_train.py::ln_bwd_plan
int sk_layernorm_bwd(int dtype, int resid_code, int out_f32, const void* x,
                     const void* dy, const void* scale, const void* resid,
                     void* dx, void* grads, void* ws, void* counter, int M,
                     int D, int blocks, int warps, int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ln_bwd<float>(resid_code, out_f32, x, dy, scale, resid, dx,
                                grads, ws, counter, M, D, blocks, warps, cols,
                                s);
  if (dtype == 1)
    return launch_ln_bwd<__nv_bfloat16>(resid_code, out_f32, x, dy, scale,
                                        resid, dx, grads, ws, counter, M, D,
                                        blocks, warps, cols, s);
  return (int)cudaErrorInvalidValue;
}

// in_code: 0 float32 rows, 1 bfloat16 rows; lanes a row (a power of two up
// to 32), warps a block, and a cluster of `cluster` (at most 8) row slices
// of rows_per_block rows a column tile, from
// ops/norm_train.py::sum_rows_plan
int sk_sum_rows(int in_code, const void* x, void* out, int R, int N,
                int lanes, int warps, int cluster, int rows_per_block,
                int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0)
    return launch_sum_rows<float>(x, out, R, N, lanes, warps, cluster,
                                  rows_per_block, vec, s);
  if (in_code == 1)
    return launch_sum_rows<__nv_bfloat16>(x, out, R, N, lanes, warps,
                                          cluster, rows_per_block, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
