// Hopper (sm_90a) attention kernels of the training stacks.
//
// Replaces the attention inside the TPU training kernels:
// sketchformer_tpu/ops/pallas_encoder_train.py::_layer_bwd_kernel (the
// recomputed forward and the backward of the encoder's self-attention),
// sketchformer_tpu/ops/pallas_decoder_train.py::_dec_stack_kernel and
// _dec_layer_bwd_kernel (causal self-attention and cross-attention to the
// Mq memory rows, forward and backward), and the small-head forms they run
// through sketchformer_tpu/ops/pallas_packed.py (group_attn_fwd / _bwd,
// ln_blocks_fwd32 / _bwd32) when head_dim < 128. Here head_dim is an
// argument (<= 128), so one kernel serves every geometry.
//
// In f32 three FMA kernels:
//   attention_fwd     one block per (32 query rows, head, batch element):
//                     optional per-head qk-norm, scores in f32 with the
//                     causal bias (an iota compare, no (T, T) tensor) and
//                     the key-mask bias, softmax, P.V. kNormP picks the
//                     rounding site: the normalised p is rounded to the
//                     compute dtype before P.V (the decoder's forward and
//                     the encoder's recompute), or the unnormalised e with
//                     the division after (the encoder's forward, as
//                     encoder_attention in encoder_stack.cu).
//   attention_bwd_q   one block per (16 query rows, head, batch element):
//                     recomputes each row's scores and softmax, dp = dO.V^T,
//                     delta = sum(dp * p), ds = p * (dp - delta) in f32 (the
//                     TPU kernel's form, not sum(dO * O)), rounds ds to the
//                     compute dtype and forms dq = ds.K * scale, then the
//                     qk-norm backward of dq. It saves each row's (max, sum,
//                     delta) for the second pass.
//   attention_bwd_kv  one block per (32 key columns, head, batch element):
//                     walks all query rows in chunks of 32, rebuilds p and ds
//                     from the saved row statistics bit for bit as the first
//                     pass had them, and sums dv = p^T.dO and dk = ds^T.Q *
//                     scale, then the qk-norm backward of dk. Every dk / dv
//                     row is owned by one warp, so no atomics: re-runs are
//                     bit-stable. The f32 qk-norm parameter gradients are
//                     per-block partial rows that one sum_rows launch adds
//                     (norm_train.cu: a cluster of row slices a column
//                     tile, its first block summing them in a fixed order).
//
// In bf16 every product runs on the tensor cores (mma.sync m16n8k16):
// the forward of the stacks and of K8 (attention_fwd_mma_kernel), which
// encoder_stack.py's encoder_attention also runs, and ragged_attention on
// packed rows (its kRagged variant, and the persistent walk over (sketch,
// head) items, ragged_attention_fwd_mma_kernel); K8's backward
// (flash_bwd_mma_kernel); and the stacks' backward, K5
// (attention_bwd_mma_kernel, whose qk-norm parameter gradients are summed
// in the same launch through split_reduce.cuh). See their notes.
//
// The same kernels are K8, the per-op attention of
// sketchformer_tpu/ops/pallas_attention.py::flash_attention (_fwd_kernel,
// _bwd_kernel), through their own entry points sk_flash_attention_fwd /
// _bwd. There the bias is a
// (B, Tk) key-mask row or a (B or 1, Tq, Tk)
// pane (a row stride and a batch stride, 0 for a shared pane), causal is
// the TPU kernel's where() after the bias (causal = 2) rather than the
// stacks' additive term before it (causal = 1), the backward's p is e *
// (1 / sum) (recip) where the stacks divide, there is no qk-norm, and dO
// and the gradients are in the compute dtype (io_dt), the gradients
// rounded at the store as _bwd_kernel rounds them.
//
// What bounds the f32 FMA kernels on the card: at Dh = 32 each score costs
// 2 * Dh FLOPs against one f32 exponential, so they are bound by
// instruction issue on the FMA and SFU units, not by memory; the bf16
// kernels move the products onto the tensor cores, and the exponentials
// and the score tiles' register traffic remain.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "split_reduce.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e9f;  // the TPU kernels' NEG_INF
constexpr int kKC = 64;           // keys staged per chunk

// one head row (Dh <= 32 * NI values) into registers, lane-strided
template <typename T, int NI>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int Dh,
                                         int lane, float (&v)[NI]) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < Dh ? to_f<T>(p[d]) : 0.f;
  }
}

// per-head qk-norm in f32, the result rounded to the compute dtype as the
// TPU kernels' _ln / ln_blocks_fwd32 are; keeps xhat and rstd for the
// backward
template <typename T, int NI>
__device__ __forceinline__ void head_norm(float (&v)[NI], int Dh, int lane,
                                          const float* __restrict__ s,
                                          const float* __restrict__ b,
                                          float (&xhat)[NI], float& rstd) {
  float sum = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    sum += v[i];
    ss += v[i] * v[i];
  }
  sum = warp_sum(sum);
  ss = warp_sum(ss);
  const float mu = sum / Dh;
  rstd = 1.f / sqrtf(fmaxf(ss / Dh - mu * mu, 0.f) + kLnEps);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    xhat[i] = d < Dh ? (v[i] - mu) * rstd : 0.f;
    if (d < Dh) v[i] = round_dt<T>(xhat[i] * s[d] + b[d]);
  }
}

// backward of head_norm for one row: dy -> dx in place; accumulates the
// parameter gradients of this lane's columns into ps / pb
template <int NI>
__device__ __forceinline__ void head_norm_bwd(float (&dy)[NI], int Dh,
                                              int lane,
                                              const float* __restrict__ s,
                                              const float (&xhat)[NI],
                                              float rstd, float (&ps)[NI],
                                              float (&pb)[NI], bool count) {
  float dxh[NI], m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    dxh[i] = d < Dh ? dy[i] * s[d] : 0.f;
    m1 += dxh[i];
    m2 += dxh[i] * xhat[i];
    if (count && d < Dh) {
      ps[i] += dy[i] * xhat[i];
      pb[i] += dy[i];
    }
  }
  m1 = warp_sum(m1) / Dh;
  m2 = warp_sum(m2) / Dh;
#pragma unroll
  for (int i = 0; i < NI; ++i) dy[i] = rstd * (dxh[i] - m1 - xhat[i] * m2);
}

// the 8 warps' partial (Dh) rows summed in warp order into out[blk * Dh]
template <int NI>
__device__ void block_partials(float* red, const float (&ps)[NI],
                               const float (&pb)[NI], int Dh, float* out_s,
                               float* out_b, size_t blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red aliases the score panes
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) {
      red[warp * Dh + d] = ps[i];
      red[(kWarps + warp) * Dh + d] = pb[i];
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float a = 0.f, c = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * Dh + d];
      c += red[(kWarps + w) * Dh + d];
    }
    out_s[blk * Dh + d] = a;
    out_b[blk * Dh + d] = c;
  }
}

struct AttnArgs {
  const void *q, *k, *v;         // head 0 of batch element 0, row 0
  long long q_bs, k_bs, v_bs;    // batch strides (elements)
  int q_rs, k_rs, v_rs;          // row strides (elements)
  const float* bias;             // additive 0 / -1e9 f32, or null: row t of
  long long bias_bs;             // batch element b at bias + b * bias_bs +
  int bias_rs;                   // t * bias_rs (key mask: bias_rs = 0)
  const float *qn_s, *qn_b, *kn_s, *kn_b;  // (Dh) qk-norm, or null
  int Tq, Tk, H, Dh;
  int causal;  // 0 none; 1 -1e9 added before the bias; 2 -1e9 set after it
  int recip;   // the backward's p = e * (1 / sum), else e / sum
  float scale;
  const int* work;  // the ragged forward's work list (see
                    // attention_fwd_mma_kernel), else null
};

// s = (q . k) * scale (+ causal bias) (+ bias) (causal where), the TPU
// kernels' order; kb is batch element b's bias
__device__ __forceinline__ float score(float acc, const AttnArgs& a,
                                       const float* kb, int t, int j) {
  float s = __fmul_rn(acc, a.scale);  // rounded before the bias, as in JAX
  if (a.causal == 1) s += j <= t ? 0.f : kNegInf;
  if (kb != nullptr) s += kb[(size_t)t * a.bias_rs + j];
  if (a.causal == 2 && j > t) s = kNegInf;
  return s;
}

__device__ __forceinline__ const float* batch_bias(const AttnArgs& a, int b) {
  return a.bias != nullptr ? a.bias + (size_t)b * a.bias_bs : nullptr;
}

// stage key rows [c0, c0 + nk) of head h, qk-normed and rounded, into kv
template <typename T, int NI>
__device__ __forceinline__ void stage_keys(const AttnArgs& a, const T* kb0,
                                           int c0, int nk, float* kv,
                                           int kvs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nk; j += kWarps) {
    float v[NI], xh[NI], rs;
    load_row<T, NI>(kb0 + (size_t)(c0 + j) * a.k_rs, a.Dh, lane, v);
    if (a.kn_s != nullptr) head_norm<T, NI>(v, a.Dh, lane, a.kn_s, a.kn_b, xh, rs);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) kv[j * kvs + d] = v[i];
    }
  }
}

template <typename T, int NI>
__device__ __forceinline__ void stage_values(const AttnArgs& a, const T* vb0,
                                             int c0, int nk, float* kv,
                                             int kvs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nk; j += kWarps) {
    const T* p = vb0 + (size_t)(c0 + j) * a.v_rs;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) kv[j * kvs + d] = to_f<T>(p[d]);
    }
  }
}

// scores of the block's R rows per warp against all keys, into sc[row][Tk]
template <typename T, int NI, int R>
__device__ void scores_rows(const AttnArgs& a, const T* kb0, const float* kb,
                            const float* qs, float* sc, float* kv, int t0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvs = a.Dh + 1;  // odd stride: lanes on different keys miss banks
  for (int c0 = 0; c0 < a.Tk; c0 += kKC) {
    const int nk = min(kKC, a.Tk - c0);
    __syncthreads();
    stage_keys<T, NI>(a, kb0, c0, nk, kv, kvs);
    __syncthreads();
    float acc[R][kKC / 32];
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) acc[rr][u] = 0.f;
    for (int d = 0; d < a.Dh; ++d) {
      float kval[kKC / 32];
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) {
        const int j = lane + 32 * u;
        kval[u] = j < nk ? kv[j * kvs + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float qv = qs[(warp * R + rr) * a.Dh + d];
#pragma unroll
        for (int u = 0; u < kKC / 32; ++u) acc[rr][u] = fmaf(qv, kval[u], acc[rr][u]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int t = min(t0 + warp * R + rr, a.Tq - 1);
      float* row = sc + (warp * R + rr) * a.Tk;
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < nk) row[c0 + j] = score(acc[rr][u], a, kb, t, c0 + j);
      }
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// attention_fwd
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 4;                  // query rows per warp
constexpr int kFwdQT = kWarps * kFwdRows;    // query rows per block

template <typename T, int NI, bool kNormP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(AttnArgs a, T* __restrict__ out, long long o_bs,
                     int o_rs) {
  extern __shared__ float smem[];
  float* qs = smem;                // [kFwdQT][Dh] normed queries
  float* sc = qs + kFwdQT * a.Dh;  // [kFwdQT][Tk] scores, then p or e
  float* kv = sc + kFwdQT * a.Tk;  // [kKC][Dh+1] staged keys or values
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kFwdQT, h = blockIdx.y, b = blockIdx.z;
  const int kvs = a.Dh + 1;
  const T* qb0 = static_cast<const T*>(a.q) + b * a.q_bs + h * a.Dh;
  const T* kb0 = static_cast<const T*>(a.k) + b * a.k_bs + h * a.Dh;
  const T* vb0 = static_cast<const T*>(a.v) + b * a.v_bs + h * a.Dh;
  const float* kb = batch_bias(a, b);
#pragma unroll
  for (int rr = 0; rr < kFwdRows; ++rr) {
    const int r = warp * kFwdRows + rr;
    const int t = min(t0 + r, a.Tq - 1);  // ragged tile: computed, not stored
    float v[NI], xh[NI], rs;
    load_row<T, NI>(qb0 + (size_t)t * a.q_rs, a.Dh, lane, v);
    if (a.qn_s != nullptr) head_norm<T, NI>(v, a.Dh, lane, a.qn_s, a.qn_b, xh, rs);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) qs[r * a.Dh + d] = v[i];
    }
  }
  __syncwarp();
  scores_rows<T, NI, kFwdRows>(a, kb0, kb, qs, sc, kv, t0);

  float denom[kFwdRows];
#pragma unroll
  for (int rr = 0; rr < kFwdRows; ++rr) {
    float* row = sc + (warp * kFwdRows + rr) * a.Tk;
    float m = -INFINITY;
    for (int j = lane; j < a.Tk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < a.Tk; j += 32) {
      const float e = expf(row[j] - m);
      sum += e;
      row[j] = kNormP ? e : round_dt<T>(e);
    }
    denom[rr] = warp_sum(sum);
    if (kNormP) {
      __syncwarp();
      for (int j = lane; j < a.Tk; j += 32) row[j] = round_dt<T>(row[j] / denom[rr]);
    }
  }
  __syncwarp();

  float o[kFwdRows][NI];
#pragma unroll
  for (int rr = 0; rr < kFwdRows; ++rr)
#pragma unroll
    for (int i = 0; i < NI; ++i) o[rr][i] = 0.f;
  for (int c0 = 0; c0 < a.Tk; c0 += kKC) {
    const int nk = min(kKC, a.Tk - c0);
    __syncthreads();
    stage_values<T, NI>(a, vb0, c0, nk, kv, kvs);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < a.Dh ? kv[j * kvs + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kFwdRows; ++rr) {
        const float p = sc[(warp * kFwdRows + rr) * a.Tk + c0 + j];
#pragma unroll
        for (int i = 0; i < NI; ++i) o[rr][i] = fmaf(p, vv[i], o[rr][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kFwdRows; ++rr) {
    const int t = t0 + warp * kFwdRows + rr;
    if (t < a.Tq) {
      T* dst = out + b * o_bs + (size_t)t * o_rs + h * a.Dh;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < a.Dh) dst[d] = from_f<T>(kNormP ? o[rr][i] : o[rr][i] / denom[rr]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// attention_bwd_q
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 2;                  // query rows per warp
constexpr int kBwdQT = kWarps * kBwdRows;    // query rows per block

struct GradArgs {
  const void* dout;    // dL/d(attention output), head 0 of element 0
  long long do_bs;
  int do_rs;
  float* stats;        // (B, H, Tq, 3): row max, row sum, delta
  void *dq, *dk, *dv;  // outputs at head 0 of element 0
  long long dq_bs, dk_bs, dv_bs;
  int dq_rs, dk_rs, dv_rs;
  float *part_s, *part_b;  // (blocks, Dh) qk-norm parameter-gradient partials
  int io_dt;           // dout and dq / dk / dv in the compute dtype, else f32
};

// K5 in bf16 (attention_bwd_mma_kernel), beside GradArgs (f32 gradients):
// dO in bf16 or f32, the rows a block owns, and the qk-norm parameter
// gradients summed in the launch: block partials and per-batch-element
// sums in ws, per-tile counters (B + 1, zero between launches), the (2, Dh)
// result in norm_grad
struct MmaBwdArgs {
  int do_f32, own_rows;  // own_rows: 64 or 96
  float *ws, *norm_grad;
  unsigned* counters;
};

template <typename T>
__device__ __forceinline__ float load_dout(const GradArgs& g, size_t i) {
  return g.io_dt ? to_f<T>(static_cast<const T*>(g.dout)[i])
                 : static_cast<const float*>(g.dout)[i];
}

template <typename T>
__device__ __forceinline__ void store_grad(const GradArgs& g, void* p,
                                           size_t i, float v) {
  if (g.io_dt)
    static_cast<T*>(p)[i] = from_f<T>(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
attention_bwd_q_kernel(AttnArgs a, GradArgs g) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBwdQT][Dh] normed queries
  float* dos = qs + kBwdQT * a.Dh;    // [kBwdQT][Dh] dO rounded to dt
  float* P = dos + kBwdQT * a.Dh;     // [kBwdQT][Tk] scores, then p
  float* DP = P + kBwdQT * a.Tk;      // [kBwdQT][Tk] dp, then rounded ds
  float* kv = DP + kBwdQT * a.Tk;     // [kKC][Dh+1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kBwdQT, h = blockIdx.y, b = blockIdx.z;
  const int kvs = a.Dh + 1;
  const T* qb0 = static_cast<const T*>(a.q) + b * a.q_bs + h * a.Dh;
  const T* kb0 = static_cast<const T*>(a.k) + b * a.k_bs + h * a.Dh;
  const T* vb0 = static_cast<const T*>(a.v) + b * a.v_bs + h * a.Dh;
  const float* kb = batch_bias(a, b);
  float qxh[kBwdRows][NI], qrs[kBwdRows];
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr) {
    const int r = warp * kBwdRows + rr;
    const int t = min(t0 + r, a.Tq - 1);
    float v[NI];
    load_row<T, NI>(qb0 + (size_t)t * a.q_rs, a.Dh, lane, v);
    if (a.qn_s != nullptr)
      head_norm<T, NI>(v, a.Dh, lane, a.qn_s, a.qn_b, qxh[rr], qrs[rr]);
    const size_t dp = b * g.do_bs + (size_t)t * g.do_rs + h * a.Dh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) {
        qs[r * a.Dh + d] = v[i];
        dos[r * a.Dh + d] = round_dt<T>(load_dout<T>(g, dp + d));
      }
    }
  }
  __syncwarp();
  scores_rows<T, NI, kBwdRows>(a, kb0, kb, qs, P, kv, t0);

  float rmax[kBwdRows], rsum[kBwdRows];
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr) {
    float* row = P + (warp * kBwdRows + rr) * a.Tk;
    float m = -INFINITY;
    for (int j = lane; j < a.Tk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < a.Tk; j += 32) {
      const float e = expf(row[j] - m);
      sum += e;
      row[j] = e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float r = 1.f / sum;
    for (int j = lane; j < a.Tk; j += 32)
      row[j] = a.recip ? row[j] * r : row[j] / sum;
    rmax[rr] = m;
    rsum[rr] = sum;
  }

  // dp = dO . V^T
  for (int c0 = 0; c0 < a.Tk; c0 += kKC) {
    const int nk = min(kKC, a.Tk - c0);
    __syncthreads();
    stage_values<T, NI>(a, vb0, c0, nk, kv, kvs);
    __syncthreads();
    float acc[kBwdRows][kKC / 32];
#pragma unroll
    for (int rr = 0; rr < kBwdRows; ++rr)
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) acc[rr][u] = 0.f;
    for (int d = 0; d < a.Dh; ++d) {
      float vval[kKC / 32];
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) {
        const int j = lane + 32 * u;
        vval[u] = j < nk ? kv[j * kvs + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kBwdRows; ++rr) {
        const float dv = dos[(warp * kBwdRows + rr) * a.Dh + d];
#pragma unroll
        for (int u = 0; u < kKC / 32; ++u) acc[rr][u] = fmaf(dv, vval[u], acc[rr][u]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kBwdRows; ++rr)
#pragma unroll
      for (int u = 0; u < kKC / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < nk) DP[(warp * kBwdRows + rr) * a.Tk + c0 + j] = acc[rr][u];
      }
  }
  __syncwarp();

  // ds = p * (dp - delta), rounded to the compute dtype
  float delta[kBwdRows];
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr) {
    const float* p = P + (warp * kBwdRows + rr) * a.Tk;
    float* dp = DP + (warp * kBwdRows + rr) * a.Tk;
    float s = 0.f;
    for (int j = lane; j < a.Tk; j += 32) s += dp[j] * p[j];
    delta[rr] = warp_sum(s);
    for (int j = lane; j < a.Tk; j += 32)
      dp[j] = round_dt<T>(p[j] * (dp[j] - delta[rr]));
  }
  __syncwarp();

  // dq = ds . K * scale
  float dq[kBwdRows][NI];
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr)
#pragma unroll
    for (int i = 0; i < NI; ++i) dq[rr][i] = 0.f;
  for (int c0 = 0; c0 < a.Tk; c0 += kKC) {
    const int nk = min(kKC, a.Tk - c0);
    __syncthreads();
    stage_keys<T, NI>(a, kb0, c0, nk, kv, kvs);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float kk[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        kk[i] = d < a.Dh ? kv[j * kvs + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kBwdRows; ++rr) {
        const float ds = DP[(warp * kBwdRows + rr) * a.Tk + c0 + j];
#pragma unroll
        for (int i = 0; i < NI; ++i) dq[rr][i] = fmaf(ds, kk[i], dq[rr][i]);
      }
    }
  }

  float ps[NI], pb[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) ps[i] = pb[i] = 0.f;
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr) {
    const int t = t0 + warp * kBwdRows + rr;
#pragma unroll
    for (int i = 0; i < NI; ++i) dq[rr][i] *= a.scale;
    if (a.qn_s != nullptr)
      head_norm_bwd<NI>(dq[rr], a.Dh, lane, a.qn_s, qxh[rr], qrs[rr], ps, pb,
                        t < a.Tq);
    if (t < a.Tq) {
      const size_t dst = b * g.dq_bs + (size_t)t * g.dq_rs + h * a.Dh;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < a.Dh) store_grad<T>(g, g.dq, dst + d, dq[rr][i]);
      }
      if (lane == 0) {
        float* st = g.stats + (((size_t)b * a.H + h) * a.Tq + t) * 3;
        st[0] = rmax[rr];
        st[1] = rsum[rr];
        st[2] = delta[rr];
      }
    }
  }
  if (a.qn_s != nullptr)
    block_partials<NI>(P, ps, pb, a.Dh, g.part_s, g.part_b,
                       ((size_t)b * a.H + h) * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------------------
// attention_bwd_kv
// ---------------------------------------------------------------------------

constexpr int kKeysPerWarp = 4;
constexpr int kKT = kWarps * kKeysPerWarp;  // key columns per block
constexpr int kQC = 32;                     // query rows per chunk (a lane each)

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kv_kernel(AttnArgs a, GradArgs g) {
  extern __shared__ float smem[];
  const int ld = a.Dh + 1;
  float* kn = smem;                 // [kKT][Dh] normed keys
  float* vs = kn + kKT * a.Dh;      // [kKT][Dh] values
  float* qc = vs + kKT * a.Dh;      // [kQC][Dh+1] normed queries of a chunk
  float* doc = qc + kQC * ld;       // [kQC][Dh+1] their dO, rounded
  float* st = doc + kQC * ld;       // [kQC][3] their row statistics
  float* PT = st + kQC * 3;         // [kKT][kQC] rounded p
  float* DST = PT + kKT * kQC;      // [kKT][kQC] rounded ds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const T* qb0 = static_cast<const T*>(a.q) + b * a.q_bs + h * a.Dh;
  const T* kb0 = static_cast<const T*>(a.k) + b * a.k_bs + h * a.Dh;
  const T* vb0 = static_cast<const T*>(a.v) + b * a.v_bs + h * a.Dh;
  const float* kb = batch_bias(a, b);
  const float* stats = g.stats + ((size_t)b * a.H + h) * a.Tq * 3;
  float kxh[kKeysPerWarp][NI], krs[kKeysPerWarp];
#pragma unroll
  for (int rr = 0; rr < kKeysPerWarp; ++rr) {
    const int r = warp * kKeysPerWarp + rr;
    const int j = min(j0 + r, a.Tk - 1);
    float v[NI], w[NI];
    load_row<T, NI>(kb0 + (size_t)j * a.k_rs, a.Dh, lane, v);
    if (a.kn_s != nullptr)
      head_norm<T, NI>(v, a.Dh, lane, a.kn_s, a.kn_b, kxh[rr], krs[rr]);
    load_row<T, NI>(vb0 + (size_t)j * a.v_rs, a.Dh, lane, w);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) {
        kn[r * a.Dh + d] = v[i];
        vs[r * a.Dh + d] = w[i];
      }
    }
  }
  float dk[kKeysPerWarp][NI], dv[kKeysPerWarp][NI];
#pragma unroll
  for (int rr = 0; rr < kKeysPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < NI; ++i) dk[rr][i] = dv[rr][i] = 0.f;

  for (int i0 = 0; i0 < a.Tq; i0 += kQC) {
    __syncthreads();
    for (int qi = warp; qi < kQC; qi += kWarps) {
      const int t = i0 + qi;
      if (t < a.Tq) {
        float v[NI], xh[NI], rs;
        load_row<T, NI>(qb0 + (size_t)t * a.q_rs, a.Dh, lane, v);
        if (a.qn_s != nullptr)
          head_norm<T, NI>(v, a.Dh, lane, a.qn_s, a.qn_b, xh, rs);
        const size_t dp = b * g.do_bs + (size_t)t * g.do_rs + h * a.Dh;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < a.Dh) {
            qc[qi * ld + d] = v[i];
            doc[qi * ld + d] = round_dt<T>(load_dout<T>(g, dp + d));
          }
        }
        if (lane < 3) st[qi * 3 + lane] = stats[(size_t)t * 3 + lane];
      } else {
        for (int d = lane; d < a.Dh; d += 32) qc[qi * ld + d] = doc[qi * ld + d] = 0.f;
        if (lane < 3) st[qi * 3 + lane] = lane == 1 ? 1.f : 0.f;
      }
    }
    __syncthreads();
    // this lane's query row against the warp's keys: p and ds
    const int t = i0 + lane;
    const bool live = t < a.Tq;
#pragma unroll
    for (int rr = 0; rr < kKeysPerWarp; ++rr) {
      const int r = warp * kKeysPerWarp + rr;
      const int j = min(j0 + r, a.Tk - 1);
      float sacc = 0.f, dpacc = 0.f;
      for (int d = 0; d < a.Dh; ++d) {
        sacc = fmaf(qc[lane * ld + d], kn[r * a.Dh + d], sacc);
        dpacc = fmaf(doc[lane * ld + d], vs[r * a.Dh + d], dpacc);
      }
      // a dead lane scores the last row: its bias row exists
      const float s = score(sacc, a, kb, live ? t : a.Tq - 1, j);
      const float e = expf(s - st[lane * 3]);
      const float p = a.recip ? e * (1.f / st[lane * 3 + 1])
                              : e / st[lane * 3 + 1];
      PT[r * kQC + lane] = live ? round_dt<T>(p) : 0.f;
      DST[r * kQC + lane] = live ? round_dt<T>(p * (dpacc - st[lane * 3 + 2])) : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < kKeysPerWarp; ++rr) {
      const int r = warp * kKeysPerWarp + rr;
      for (int qi = 0; qi < kQC; ++qi) {
        const float pv = PT[r * kQC + qi], dsv = DST[r * kQC + qi];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < a.Dh) {
            dv[rr][i] = fmaf(pv, doc[qi * ld + d], dv[rr][i]);
            dk[rr][i] = fmaf(dsv, qc[qi * ld + d], dk[rr][i]);
          }
        }
      }
    }
  }

  float ps[NI], pb[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) ps[i] = pb[i] = 0.f;
#pragma unroll
  for (int rr = 0; rr < kKeysPerWarp; ++rr) {
    const int j = j0 + warp * kKeysPerWarp + rr;
#pragma unroll
    for (int i = 0; i < NI; ++i) dk[rr][i] *= a.scale;
    if (a.kn_s != nullptr)
      head_norm_bwd<NI>(dk[rr], a.Dh, lane, a.kn_s, kxh[rr], krs[rr], ps, pb,
                        j < a.Tk);
    if (j < a.Tk) {
      const size_t dkd = b * g.dk_bs + (size_t)j * g.dk_rs + h * a.Dh;
      const size_t dvd = b * g.dv_bs + (size_t)j * g.dv_rs + h * a.Dh;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < a.Dh) {
          store_grad<T>(g, g.dk, dkd + d, dk[rr][i]);
          store_grad<T>(g, g.dv, dvd + d, dv[rr][i]);
        }
      }
    }
  }
  if (a.kn_s != nullptr)
    block_partials<NI>(qc, ps, pb, a.Dh, g.part_s, g.part_b,
                       ((size_t)b * a.H + h) * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// K8's backward in bf16: the five products on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces sketchformer_tpu/ops/pallas_attention.py::_bwd_kernel (:207), which
// holds a whole (Tq, Tk) pane in VMEM and runs five MXU products. Here one
// kernel template runs as two launches over 64-row tiles, 4 warps a block,
// each warp owning 16 rows, and sweeps the other side in 32-row tiles staged
// by cp.async into a double buffer (rows padded by 8 elements, so ldmatrix
// reads hit distinct banks). Every product is mma.sync m16n8k16 (bf16 in,
// f32 accumulate); the score tiles stay in registers, and a product's C
// fragments are the next product's A fragments.
//   kDkv false  a block owns 64 query rows: the first sweep over the keys
//               forms S = Q.K^T and dP = dO.V^T and keeps the running max,
//               sum of exp and sum of exp * dp (online, rescaled as the max
//               grows); then p = exp(s - max) * (1 / sum) and delta = the
//               last over the sum, which is sum_j(dp * p) over every key (the
//               TPU kernel's form). The second sweep recomputes S and dP,
//               forms ds = round(p * (dp - delta)) and dq += ds.K; it stores
//               dq and each row's (max, sum, delta).
//   kDkv true   a block owns 64 key rows and sweeps the queries: S^T =
//               K.Q^T, dP^T = V.dO^T, p and ds from the saved statistics,
//               dv += round(p)^T.dO and dk += ds^T.Q.
// Every dq, dk and dv row has one owner, so there are no atomics and re-runs
// are bit-stable. What bounds it: at T = 192 and Dh = 32 the products are
// small, so the exponentials (three a score) and the score tiles' register
// traffic set the time, not the bytes (each operand is read ~T/32 times from
// L2).

constexpr int kFbOwn = 64, kFbIn = 32, kFbThreads = 128;

// the K8 score of query t and key j (both clamped into the bias pane)
__device__ __forceinline__ float fb_score(float acc, const AttnArgs& a,
                                          const float* kb, int t, int j) {
  float s = __fmul_rn(acc, a.scale);
  if (kb != nullptr)
    s += kb[(size_t)min(t, a.Tq - 1) * a.bias_rs + min(j, a.Tk - 1)];
  if (a.causal == 2 && j > t) s = kNegInf;
  return s;
}

template <int kDh, bool kDkv>
__global__ void __launch_bounds__(kFbThreads)
flash_bwd_mma_kernel(AttnArgs a, GradArgs g) {
  using bf = __nv_bfloat16;
  constexpr int kLd = kDh + 8;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  bf* own1 = reinterpret_cast<bf*>(fb_smem);  // [64][kLd]: Q (K for dkv)
  bf* own2 = own1 + kFbOwn * kLd;             //           dO (V)
  bf* inb = own2 + kFbOwn * kLd;              // [2][2][32][kLd]: K, V (Q, dO)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int r0 = blockIdx.x * kFbOwn, h = blockIdx.y, b = blockIdx.z;
  const int Tow = kDkv ? a.Tk : a.Tq, Tin = kDkv ? a.Tq : a.Tk;
  const bf* q = static_cast<const bf*>(a.q) + b * a.q_bs + h * a.Dh;
  const bf* k = static_cast<const bf*>(a.k) + b * a.k_bs + h * a.Dh;
  const bf* v = static_cast<const bf*>(a.v) + b * a.v_bs + h * a.Dh;
  const bf* dO = static_cast<const bf*>(g.dout) + b * g.do_bs + h * a.Dh;
  const bf* o1 = kDkv ? k : q;
  const bf* o2 = kDkv ? v : dO;
  const bf* i1 = kDkv ? q : k;
  const bf* i2 = kDkv ? dO : v;
  const int o1s = kDkv ? a.k_rs : a.q_rs, o2s = kDkv ? a.v_rs : g.do_rs;
  const int i1s = kDkv ? a.q_rs : a.k_rs, i2s = kDkv ? g.do_rs : a.v_rs;
  const float* kb = batch_bias(a, b);

  // zero everything once: the columns past Dh are never written again
  for (int i = tid; i < (2 * kFbOwn + 4 * kFbIn) * kLd / 8; i += kFbThreads)
    reinterpret_cast<uint4*>(fb_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto stage = [&](bf* dst, const bf* src, int rs, int row0, int n, int T) {
    stage_rows<kLd, kFbThreads>(dst, src, rs, row0, n, T, a.Dh);
  };
  stage(own1, o1, o1s, r0, kFbOwn, Tow);
  stage(own2, o2, o2s, r0, kFbOwn, Tow);
  cp_async_commit();

  const int ntiles = (Tin + kFbIn - 1) / kFbIn;
  // one sweep over the other side: body(tile start, its two smem tiles)
  auto sweep = [&](auto&& body) {
    stage(inb, i1, i1s, 0, kFbIn, Tin);
    stage(inb + kFbIn * kLd, i2, i2s, 0, kFbIn, Tin);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) {
        bf* nb = inb + ((it + 1) & 1) * 2 * kFbIn * kLd;
        stage(nb, i1, i1s, (it + 1) * kFbIn, kFbIn, Tin);
        stage(nb + kFbIn * kLd, i2, i2s, (it + 1) * kFbIn, kFbIn, Tin);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf* cb = inb + (it & 1) * 2 * kFbIn * kLd;
      body(it * kFbIn, cb, cb + kFbIn * kLd);
      __syncthreads();
    }
  };

  // this thread's two owned rows: gq and gq + 8 of the warp's 16
  const int rowA = r0 + warp * 16 + gq;
  float acc1[kDh / 8][4], acc2[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;

  if constexpr (!kDkv) {
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f},
          sd[2] = {0.f, 0.f};
    sweep([&](int j0, const bf* kt, const bf* vt) {
      float s[4][4], dp[4][4];
      warp_qk<kDh, kLd>(s, own1, kt);
      warp_qk<kDh, kLd>(dp, own2, vt);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = rowA + 8 * (i >> 1), j = j0 + nt * 8 + 2 * cq + (i & 1);
          s[nt][i] = j < a.Tk ? fb_score(s[nt][i], a, kb, t, j) : -INFINITY;
          tmax[i >> 1] = fmaxf(tmax[i >> 1], s[nt][i]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float mn = fmaxf(mx[r], tmax[r]);
        const float f = expf(mx[r] - mn);  // 0 on the first tile
        float es = 0.f, ed = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 2 * r; i < 2 * r + 2; ++i) {
            const float e = expf(s[nt][i] - mn);
            es += e;
            ed += e * dp[nt][i];
          }
        es += __shfl_xor_sync(0xffffffffu, es, 1);
        es += __shfl_xor_sync(0xffffffffu, es, 2);
        ed += __shfl_xor_sync(0xffffffffu, ed, 1);
        ed += __shfl_xor_sync(0xffffffffu, ed, 2);
        sm[r] = sm[r] * f + es;
        sd[r] = sd[r] * f + ed;
        mx[r] = mn;
      }
    });
    const float inv[2] = {1.f / sm[0], 1.f / sm[1]};
    const float delta[2] = {sd[0] * inv[0], sd[1] * inv[1]};
    sweep([&](int j0, const bf* kt, const bf* vt) {
      float s[4][4], dp[4][4];
      warp_qk<kDh, kLd>(s, own1, kt);
      warp_qk<kDh, kLd>(dp, own2, vt);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int t = rowA + 8 * r, j = j0 + nt * 8 + 2 * cq + (i & 1);
          const float sv = j < a.Tk ? fb_score(s[nt][i], a, kb, t, j)
                                    : -INFINITY;
          const float p = expf(sv - mx[r]) * inv[r];
          dp[nt][i] = p * (dp[nt][i] - delta[r]);
        }
      uint32_t pa[2][4];
      c_to_a(pa, dp);
      warp_pv<kDh, kLd>(acc1, pa, kt);
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = rowA + 8 * r;
      if (t >= a.Tq) continue;
      bf* dst = static_cast<bf*>(g.dq) + b * g.dq_bs + (size_t)t * g.dq_rs +
                h * a.Dh;
#pragma unroll
      for (int nd = 0; nd < kDh / 8; ++nd) {
        const int c = nd * 8 + 2 * cq;
        if (c < a.Dh)
          *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
              acc1[nd][2 * r] * a.scale, acc1[nd][2 * r + 1] * a.scale);
      }
      if (cq == 0) {
        float* st = g.stats + (((size_t)b * a.H + h) * a.Tq + t) * 3;
        st[0] = mx[r];
        st[1] = sm[r];
        st[2] = delta[r];
      }
    }
  } else {
    const float* stats = g.stats + ((size_t)b * a.H + h) * a.Tq * 3;
    sweep([&](int t0, const bf* qt, const bf* dot) {
      float s[4][4], dp[4][4];
      warp_qk<kDh, kLd>(s, own1, qt);
      warp_qk<kDh, kLd>(dp, own2, dot);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = rowA + 8 * (i >> 1), t = t0 + nt * 8 + 2 * cq + (i & 1);
          float p = 0.f, ds = 0.f;
          if (t < a.Tq) {
            const float* st = stats + (size_t)t * 3;
            p = expf(fb_score(s[nt][i], a, kb, t, j) - st[0]) * (1.f / st[1]);
            ds = p * (dp[nt][i] - st[2]);
          }
          s[nt][i] = p;
          dp[nt][i] = ds;
        }
      uint32_t pa[2][4];
      c_to_a(pa, s);
      warp_pv<kDh, kLd>(acc2, pa, dot);   // dv += p^T . dO
      c_to_a(pa, dp);
      warp_pv<kDh, kLd>(acc1, pa, qt);    // dk += ds^T . Q
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = rowA + 8 * r;
      if (j >= a.Tk) continue;
      bf* dk = static_cast<bf*>(g.dk) + b * g.dk_bs + (size_t)j * g.dk_rs +
               h * a.Dh;
      bf* dv = static_cast<bf*>(g.dv) + b * g.dv_bs + (size_t)j * g.dv_rs +
               h * a.Dh;
#pragma unroll
      for (int nd = 0; nd < kDh / 8; ++nd) {
        const int c = nd * 8 + 2 * cq;
        if (c >= a.Dh) continue;
        *reinterpret_cast<__nv_bfloat162*>(dk + c) = __floats2bfloat162_rn(
            acc1[nd][2 * r] * a.scale, acc1[nd][2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + c) = __floats2bfloat162_rn(
            acc2[nd][2 * r], acc2[nd][2 * r + 1]);
      }
    }
  }
}

template <int kDh>
int launch_flash_bwd_mma(const AttnArgs& a, const GradArgs& g, int B,
                         cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kFbOwn + 4 * kFbIn) * (kDh + 8) * 2;
  int err = set_smem(flash_bwd_mma_kernel<kDh, false>, smem);
  if (err) return err;
  err = set_smem(flash_bwd_mma_kernel<kDh, true>, smem);
  if (err) return err;
  flash_bwd_mma_kernel<kDh, false>
      <<<dim3((a.Tq + kFbOwn - 1) / kFbOwn, a.H, B), kFbThreads, smem,
         stream>>>(a, g);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_mma_kernel<kDh, true>
      <<<dim3((a.Tk + kFbOwn - 1) / kFbOwn, a.H, B), kFbThreads, smem,
         stream>>>(a, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// attention_fwd in bf16: the scores and P.V on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces, in bf16, the FMA body of attention_fwd_kernel (the f32 forward
// keeps it) for every caller: the stacks' forward and recompute (qk-norm,
// causal added before the key bias) and K8's forward (sk_flash_attention_fwd:
// a bias row or pane, causal as a where() after it). A block owns 64 query
// rows, 4 warps of 16, as flash_bwd_mma_kernel does; the keys and values
// stream through a cp.async double buffer of 32-row tiles, every product is
// mma.sync m16n8k16 (bf16 in, f32 accumulate), and a score tile stays in C
// fragments, which become P.V's A fragments. The rounding sites need each
// row's final max, so the keys are swept twice:
//   1. S = Q.K^T, scaled and biased in score()'s order, gives the row max
//      and, with kNormP, the f32 sum of exp (rescaled as the max grows);
//   2. S again, then p = round(exp(s - max) / sum) (kNormP), or e =
//      round(exp(s - max)) with the f32 sum of the unrounded exp taken
//      here against the final max and the division after (!kNormP); O +=
//      p.V.
// qk-norm: the Q tile is normalised once in shared memory (f32 statistics,
// rounded as head_norm rounds). Streaming, each K tile is normalised after
// it lands, so each key is normalised twice a block (once a sweep): at
// T = 192, 6 times a head. kResident (the host's choice, ops/
// attention_train.py::fwd_resident: under qk-norm where the head's whole
// K and V fit 40 KB with the Q tile, Tk <= 224 at Dh = 32, 96 at Dh = 64,
// 32 at Dh = 128) stages every key and
// value row of the head at once, normalises each key once, and runs both
// sweeps from shared memory with no barrier between tiles. Keys past Tk
// are excluded by index from the max, the sum and P.V. Each output row has
// one owner, so re-runs are bit-stable. At Dh = 32 a score costs 2 Dh
// FLOPs against one or two exponentials, so the products are not what
// bounds it (a 64-row wgmma tile would buy nothing).
//
// kRagged: the inference encoder stack on packed rows (encoder_stack.py::
// ragged_attention's "tiles" route; no TPU kernel: the TPU pads every
// sketch to T). The sketches' valid rows lie back to back in q, k and v;
// a.work lists one (first query row, sketch's first row, sketch's length)
// triple a 64-row query block, and the grid is (work items, heads). A
// block takes its sketch as its batch element: rows counted from the
// sketch's first, Tq = Tk = its length, no bias. So a block reads only its
// sketch's keys, in 32-key tiles counted from the sketch's first row, and
// a padded batch's query blocks and key tiles of padding are not computed
// at all. The padded layout gives a valid row the same tiles, and its
// masked keys add exact zeros to the max, the sum and P.V, so a valid
// row's output is the padded kernel's bit for bit. Only !kNormP is built
// ragged (the numerics of encoder_attention). The padded instantiations
// compile as before. What bounds the ragged grid is exposed memory
// latency, not the exponentials: at the embed cell's batch (B = 2048,
// lengths 16-191) a block pays about 2 ntiles + 1 dependent rounds of
// loads, each a cp.async wait and a block barrier, with one 64 x 32 tile
// of work between, and it reads the sketch-head's K and V once a query
// block: 0.88 ms against 0.13 ms for its bytes once (PERF.md section 6,
// K2). The persistent walk below serves that batch instead.

// qk-norm of rows [0, n) of a bf16 tile in shared memory (row stride
// kDh + 8), in place, by the block's kThreads threads: kDh / 8 neighbouring
// threads a row, 16 bytes each, the row's sums reduced across them;
// head_norm's f32 statistics and rounding
template <int kDh, int kThreads = kFbThreads>
__device__ __forceinline__ void norm_rows(__nv_bfloat16* t, int n, int Dh,
                                          const float* __restrict__ ps,
                                          const float* __restrict__ pb) {
  constexpr int kTpr = kDh / 8, kRows = kThreads / kTpr, kLd = kDh + 8;
  const int c = (threadIdx.x % kTpr) * 8, rr = threadIdx.x / kTpr;
  for (int r = rr; r < (n + kRows - 1) / kRows * kRows; r += kRows) {
    const bool ok = r < n;  // every lane shuffles, in or past the tile
    uint4 u = ok ? *reinterpret_cast<const uint4*>(t + r * kLd + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
    float v[8], sum = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = c + i < Dh ? __bfloat162float(e[i]) : 0.f;
      sum += v[i];
      ss += v[i] * v[i];
    }
#pragma unroll
    for (int o = 1; o < kTpr; o <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = sum / Dh;
    const float rstd = 1.f / sqrtf(fmaxf(ss / Dh - mu * mu, 0.f) + kLnEps);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < Dh)
        e[i] = __float2bfloat16((v[i] - mu) * rstd * ps[c + i] + pb[c + i]);
    if (ok) *reinterpret_cast<uint4*>(t + r * kLd + c) = u;
  }
}

// round(e / sum) to bf16 exactly as the IEEE quotient rounds: e * inv (inv
// = 1 / sum, rounded) lies within 2 ulp of the quotient, so the two round
// alike unless e * inv sits within 2 ulp of a bf16 rounding boundary (its
// low 16 bits near 0x8000), where the division itself decides
__device__ __forceinline__ float div_round_bf16(float e, float sum,
                                                float inv) {
  float q = e * inv;
  if ((__float_as_uint(q) & 0xFFFFu) - 0x7FFEu <= 4u) q = e / sum;
  return round_dt<__nv_bfloat16>(q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// blocks an SM: 7 at Dh = 32, 5 at Dh = 64, 4 at Dh = 128 (72, 96 and 128
// registers a thread); the compiler left alone takes more registers and
// fewer blocks fit, which cost 10-15% (an A/B on one card)
template <int kDh, bool kNormP, bool kResident, bool kRagged = false>
__global__ void __launch_bounds__(kFbThreads,
                                  kDh == 32 ? 7 : kDh == 64 ? 5 : 4)
attention_fwd_mma_kernel(AttnArgs a, __nv_bfloat16* __restrict__ out,
                         long long o_bs, int o_rs) {
  using bf = __nv_bfloat16;
  constexpr int kLd = kDh + 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf* qs = reinterpret_cast<bf*>(fa_smem);  // [64][kLd] the (normed) queries
  // streaming: [2][2][32][kLd] K, V tiles; resident: [Tk32][kLd] K, then V
  bf* kvb = qs + kFbOwn * kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  int r0 = blockIdx.x * kFbOwn;
  if constexpr (kRagged) {
    const int* w = a.work + 3 * (size_t)blockIdx.x;
    const int q0 = w[0], s0 = w[1];
    a.Tq = a.Tk = w[2];
    r0 = q0 - s0;
    a.q = static_cast<const bf*>(a.q) + (size_t)s0 * a.q_rs;
    a.k = static_cast<const bf*>(a.k) + (size_t)s0 * a.k_rs;
    a.v = static_cast<const bf*>(a.v) + (size_t)s0 * a.v_rs;
    out += (size_t)s0 * o_rs;
  }
  const int h = blockIdx.y, b = blockIdx.z;
  const bf* q = static_cast<const bf*>(a.q) + b * a.q_bs + h * a.Dh;
  const bf* k = static_cast<const bf*>(a.k) + b * a.k_bs + h * a.Dh;
  const bf* v = static_cast<const bf*>(a.v) + b * a.v_bs + h * a.Dh;
  const float* kb = batch_bias(a, b);

  // zero everything once: the columns past Dh are never written again
  const int rows =
      kFbOwn + 2 * (kResident ? (a.Tk + kFbIn - 1) / kFbIn * kFbIn : 2 * kFbIn);
  for (int i = tid; i < rows * kLd / 8; i += kFbThreads)
    reinterpret_cast<uint4*>(fa_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto stage = [&](bf* dst, const bf* src, int rs, int row0, int n, int T) {
    stage_rows<kLd, kFbThreads>(dst, src, rs, row0, n, T, a.Dh);
  };
  // streaming: the two sweeps run as one cp.async pipeline of 2 ntiles
  // steps: step it (key tile it % ntiles, with its V tile in the second
  // sweep) lands in buffer it % 2 while step it - 1 computes
  const int ntiles = (a.Tk + kFbIn - 1) / kFbIn;
  auto load = [&](int it) {
    bf* kt = kvb + (it & 1) * 2 * kFbIn * kLd;
    const int j0 = (it % ntiles) * kFbIn;
    stage(kt, k, a.k_rs, j0, kFbIn, a.Tk);
    if (it >= ntiles) stage(kt + kFbIn * kLd, v, a.v_rs, j0, kFbIn, a.Tk);
    cp_async_commit();
  };
  stage(qs, q, a.q_rs, r0, kFbOwn, a.Tq);
  if constexpr (kResident) {
    stage(kvb, k, a.k_rs, 0, ntiles * kFbIn, a.Tk);
    stage(kvb + ntiles * kFbIn * kLd, v, a.v_rs, 0, ntiles * kFbIn, a.Tk);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    cp_async_commit();
    load(0);
    cp_async_wait<1>();
  }
  __syncthreads();
  if (a.qn_s != nullptr) {
    norm_rows<kDh>(qs, min(kFbOwn, a.Tq - r0), a.Dh, a.qn_s, a.qn_b);
    if constexpr (kResident) norm_rows<kDh>(kvb, a.Tk, a.Dh, a.kn_s, a.kn_b);
    __syncthreads();
  }
  // step it's K (normed) and V tiles, after every earlier step's reads
  // (resident: key tile it % ntiles, its V tile ntiles tiles on)
  auto step_tiles = [&](int it) {
    if constexpr (kResident) {
      return kvb + (it % ntiles) * kFbIn * kLd;
    } else {
      if (it + 1 < 2 * ntiles) {
        load(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      bf* kt = kvb + (it & 1) * 2 * kFbIn * kLd;
      if (a.kn_s != nullptr) {
        norm_rows<kDh>(kt, min(kFbIn, a.Tk - (it % ntiles) * kFbIn), a.Dh,
                       a.kn_s, a.kn_b);
        __syncthreads();
      }
      return kt;
    }
  };

  // this thread's two rows, gq and gq + 8 of the warp's 16 (a ragged tile's
  // rows past Tq are computed at row Tq - 1 and not stored), and their bias
  // rows (one row for a key bias, bias_rs = 0)
  const int rowA = r0 + warp * 16 + gq;
  const int tr[2] = {min(rowA, a.Tq - 1), min(rowA + 8, a.Tq - 1)};
  const float* kbr[2] = {kb, kb};
  if (kb != nullptr) {
    kbr[0] = kb + (size_t)tr[0] * a.bias_rs;
    kbr[1] = kb + (size_t)tr[1] * a.bias_rs;
  }
  // the scores of the tile at key j0 (C fragment element (nt, i): key j0 +
  // 8 nt + 2 cq + i % 2), in score()'s order; -inf for a key past Tk
  auto scores = [&](float (&s)[4][4], const bf* kt, int j0) {
    warp_qk<kDh, kLd>(s, qs, kt);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + nt * 8 + 2 * cq + e;
        float bj[2] = {0.f, 0.f};
        if (kb != nullptr && j < a.Tk) {
          bj[0] = kbr[0][j];
          bj[1] = a.bias_rs == 0 ? bj[0] : kbr[1][j];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = __fmul_rn(s[nt][2 * r + e], a.scale);
          if (a.causal == 1) v += j <= tr[r] ? 0.f : kNegInf;
          if (kb != nullptr) v += bj[r];
          if (a.causal == 2 && j > tr[r]) v = kNegInf;
          s[nt][2 * r + e] = j < a.Tk ? v : -INFINITY;
        }
      }
  };

  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  for (int it = 0; it < ntiles; ++it) {
    const bf* kt = step_tiles(it);
    float s[4][4];
    scores(s, kt, it * kFbIn);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        tmax = fmaxf(tmax, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float mn = fmaxf(mx[r], quad_max(tmax));
      if constexpr (kNormP) {
        float es = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          es += expf(s[nt][2 * r] - mn) + expf(s[nt][2 * r + 1] - mn);
        sm[r] = sm[r] * expf(mx[r] - mn) + quad_sum(es);  // 0 * 0 at first
      }
      mx[r] = mn;
    }
    if constexpr (!kResident) __syncthreads();  // the buffer is reloaded
  }

  float o[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float es[2] = {0.f, 0.f};
  const float inv[2] = {1.f / sm[0], 1.f / sm[1]};
  for (int it = ntiles; it < 2 * ntiles; ++it) {
    const bf* kt = step_tiles(it);
    float s[4][4];
    scores(s, kt, (it - ntiles) * kFbIn);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float e = expf(s[nt][i] - mx[r]);  // 0 past Tk
        if constexpr (kNormP) {
          s[nt][i] = div_round_bf16(e, sm[r], inv[r]);
        } else {
          es[r] += e;
          s[nt][i] = e;  // rounded to bf16 as c_to_a packs it
        }
      }
    uint32_t pa[2][4];
    c_to_a(pa, s);
    warp_pv<kDh, kLd>(o, pa, kt + (kResident ? ntiles : 1) * kFbIn * kLd);
    if constexpr (!kResident) __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = kNormP ? 1.f : quad_sum(es[r]);
    const int t = rowA + 8 * r;
    if (t >= a.Tq) continue;
    bf* dst = out + b * o_bs + (size_t)t * o_rs + h * a.Dh;
#pragma unroll
    for (int nd = 0; nd < kDh / 8; ++nd) {
      const int c = nd * 8 + 2 * cq;
      if (c < a.Dh) {
        const float v0 = o[nd][2 * r], v1 = o[nd][2 * r + 1];
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            kNormP ? __floats2bfloat162_rn(v0, v1)
                   : __floats2bfloat162_rn(v0 / den, v1 / den);
      }
    }
  }
}

// the bf16 forward's shapes: Dh a multiple of 16 up to 128, q / k / v at
// 16-byte-aligned addresses and strides (out: its rows 4-byte aligned)
bool fwd_mma_shapes_ok(const AttnArgs& a, const void* out, long long o_bs,
                       int o_rs) {
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return a.Dh % 16 == 0 && a.Dh <= 128 && al16(a.q) && al16(a.k) &&
         al16(a.v) && (a.q_rs | a.k_rs | a.v_rs) % 8 == 0 &&
         (a.q_bs | a.k_bs | a.v_bs) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0 && (o_rs | o_bs) % 2 == 0;
}

// whole: the whole-head variant (kResident), the host's choice; a head
// whose K and V exceed the card's shared memory fails in set_smem. W > 0:
// the ragged variant (norm_p false) over a.work's W items, a grid of (W,
// heads); a.Tk, the longest sketch, sizes the whole-head variant
template <int kDh>
int launch_fwd_mma_dh(const AttnArgs& a, void* out, long long o_bs, int o_rs,
                      int norm_p, int whole, int B, cudaStream_t stream,
                      int W) {
  const size_t row = (kDh + 8) * 2;
  const size_t smem =
      whole ? (kFbOwn + 2 * (size_t)((a.Tk + kFbIn - 1) / kFbIn) * kFbIn) * row
            : (kFbOwn + 4 * kFbIn) * row;
  auto kernel =
      W > 0 ? (whole ? attention_fwd_mma_kernel<kDh, false, true, true>
                     : attention_fwd_mma_kernel<kDh, false, false, true>)
      : whole ? (norm_p ? attention_fwd_mma_kernel<kDh, true, true>
                        : attention_fwd_mma_kernel<kDh, false, true>)
              : (norm_p ? attention_fwd_mma_kernel<kDh, true, false>
                        : attention_fwd_mma_kernel<kDh, false, false>);
  int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid = W > 0 ? dim3(W, a.H)
                          : dim3((a.Tq + kFbOwn - 1) / kFbOwn, a.H, B);
  kernel<<<grid, kFbThreads, smem, stream>>>(
      a, static_cast<__nv_bfloat16*>(out), o_bs, o_rs);
  return (int)cudaGetLastError();
}

int launch_fwd_mma(const AttnArgs& a, void* out, long long o_bs, int o_rs,
                   int norm_p, int whole, int B, cudaStream_t s, int W = 0) {
  if (!fwd_mma_shapes_ok(a, out, o_bs, o_rs) || (W > 0 && norm_p))
    return (int)cudaErrorInvalidValue;
  if (a.Dh <= 32)
    return launch_fwd_mma_dh<32>(a, out, o_bs, o_rs, norm_p, whole, B, s, W);
  if (a.Dh <= 64)
    return launch_fwd_mma_dh<64>(a, out, o_bs, o_rs, norm_p, whole, B, s, W);
  return launch_fwd_mma_dh<128>(a, out, o_bs, o_rs, norm_p, whole, B, s, W);
}

// ---------------------------------------------------------------------------
// the ragged forward as a persistent walk over (sketch, head) items
// ---------------------------------------------------------------------------
//
// What ragged_attention sends on the embed path (bf16, Dh = 32, no qk-norm,
// no sketch longer than a stage's kRpRows rows: ops/encoder_stack.py::
// ragged_route) runs here; anything else keeps the kRagged grid above. That
// grid gives each 64-row query block its own block, which waits through
// about 2 ntiles + 1 dependent rounds of loads (the q tile, then every key
// tile once a sweep), each a cp.async wait and a block barrier with one
// tile's products between, and reads its sketch-head's K and V once a query
// block (K twice): exposed memory latency, not the exponentials or the
// products, set its time (PERF.md section 6, K2).
//
// Here the grid is persistent (the blocks an SM that sk_ragged_fit's
// occupancy query allows: two, by the stages' 92 KB), and block b walks
// the items b, b + grid, ... of a fixed list: item i is head i % H of the
// sketch items[i / H] (its first packed row and its length n; the host
// lists the sketches longest first, so the blocks' walks carry about equal
// work). Warp 0 produces: it stages an item's q, K and V boxes (n rows x Dh
// columns at columns h Dh, HD + h Dh and 2 HD + h Dh of the packed pane; q
// zero to the next 16 rows, K and V to the next 32) by cp.async into one of
// two stages, each lane's copies arriving on the stage's full mbarrier as
// they land, and refills a stage once every consumer warp has released it
// (its empty mbarrier). So item i + 1's loads are in flight while item i
// computes, and a sketch-head's q, K and V leave device memory once. The
// kRpWarps consumer warps take the block's 16-row query slices in turn
// (slice g of the block's walk to warp g % kRpWarps, across items, so no
// warp keeps every item's remainder), and each slice runs the two sweeps
// of the kRagged variant from the stage with no block barrier: sweep 1 the
// scores, kept in registers (up to kRpTiles tiles of 16 a lane), and the
// row max; sweep 2 the exponentials rounded to bf16 for P.V with their f32
// sum, then the division. The 32-key tiles counted from the sketch's first
// row, the warp_qk / warp_pv / c_to_a order, the keys past n excluded by
// index, the sums' order and the zero rows past n (computed, not stored)
// are that variant's, so every output is its bit for bit; no state crosses
// items and each output row has one owner, so re-runs are bit-stable.
//
// What bounds it (NVIDIA H100, PERF.md section 6, K2): instruction issue.
// At the embed cell's batch it takes 0.375 ms, against 0.313 ms with no
// loads at all and 0.154 ms with no compute; at Dh = 32 an exponential
// (expf, kept for the bits) costs about 9 instructions against a score's
// 64 FLOPs of products, and the consumers issue ~450 instructions a
// 16 x 32 tile. Keeping sweep 1's scores (161 registers, so 4 consumer
// warps a block) took 0.414 -> 0.375 ms; 4, 8 or 12 consumer warps
// recomputing them ran within 7% of each other.

constexpr int kRpRows = 192;  // a stage's rows: the longest sketch it takes
constexpr int kRpDh = 32;
constexpr int kRpLd = kRpDh + 8;  // padded rows: ldmatrix hits distinct banks
constexpr int kRpWarps = 4;       // consumer warps; warp 0 produces
constexpr int kRpThreads = 32 * (kRpWarps + 1);
constexpr int kRpStages = 2;
constexpr int kRpStage = 3 * kRpRows * kRpLd;  // a stage's q, K, V elements
constexpr int kRpTiles = kRpRows / kFbIn;      // key tiles of a stage
constexpr size_t kRpSmem =
    (size_t)kRpStages * kRpStage * 2 + 2 * kRpStages * sizeof(uint64_t);

// each of this thread's cp.async copies so far arrives on mbarrier bar once
// it lands (the arrival counted in bar's expected count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__global__ void __launch_bounds__(kRpThreads, 2)
ragged_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, int rs,
                                const int2* __restrict__ items, int nitems,
                                int H, float scale,
                                __nv_bfloat16* __restrict__ out, int o_rs) {
  using bf = __nv_bfloat16;
  constexpr int kDh = kRpDh, kLd = kRpLd;
  extern __shared__ __align__(16) unsigned char rp_smem[];
  bf* stages = reinterpret_cast<bf*>(rp_smem);
  // full[s] = bars[s] (the producer's 32 lanes), empty[s] = bars[kRpStages
  // + s] (the consumer warps)
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kRpStages * kRpStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kRpStages; ++s) {
      mbar_init(smem_u32(bars + s), 32);
      mbar_init(smem_u32(bars + kRpStages + s), kRpWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  RingPos p;
  if (warp == 0) {
    for (int it = blockIdx.x, n = 0; it < nitems; it += gridDim.x, ++n) {
      if (n >= kRpStages)
        mbar_wait(smem_u32(bars + kRpStages + p.s), p.phase ^ 1u);
      const int2 e = items[it / H];
      const size_t off = (size_t)e.x * rs + (it % H) * kDh;
      bf* st = stages + p.s * kRpStage;
      stage_rows<kLd, 32>(st, q + off, rs, 0, (e.y + 15) & ~15, e.y, kDh);
      stage_rows<kLd, 32>(st + kRpRows * kLd, k + off, rs, 0,
                          (e.y + 31) & ~31, e.y, kDh);
      stage_rows<kLd, 32>(st + 2 * kRpRows * kLd, v + off, rs, 0,
                          (e.y + 31) & ~31, e.y, kDh);
      cp_async_arrive(smem_u32(bars + p.s));
      p.next(kRpStages);
    }
    cp_async_wait<0>();
    return;
  }

  const int cw = warp - 1, cq = lane & 3;
  int turn = 0;  // the block's slices walked so far, modulo kRpWarps
  for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
    const int2 e = items[it / H];
    const int n = e.y, nsl = (n + 15) >> 4, ntiles = (n + kFbIn - 1) / kFbIn;
    mbar_wait(smem_u32(bars + p.s), p.phase);
    const bf* qs = stages + p.s * kRpStage;
    const bf* ks = qs + kRpRows * kLd;
    const bf* vs = ks + kRpRows * kLd;
    bf* dst = out + (size_t)e.x * o_rs + (it % H) * kDh;
    for (int sl = (cw - turn + kRpWarps) % kRpWarps; sl < nsl;
         sl += kRpWarps) {
      // warp_qk reads rows warp * 16 + i of its first operand: this slice's
      const bf* own = qs + (sl - warp) * 16 * kLd;
      // sweep 1: every tile's scores, kept for sweep 2 (C fragment element
      // (nt, i) of tile t: key 32 t + 8 nt + 2 cq + i % 2; -inf past n),
      // and this lane's max of each of its two rows, then the row's
      float sc[kRpTiles][4][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < kRpTiles; ++t) {
        if (t >= ntiles) break;
        warp_qk<kDh, kLd>(sc[t], own, ks + t * kFbIn * kLd);
        const int lim = n - t * kFbIn - 2 * cq;  // past n: 8 nt + i % 2 >= lim
        if (lim >= kFbIn) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sc[t][nt][i] = __fmul_rn(sc[t][nt][i], scale);
              mx[i >> 1] = fmaxf(mx[i >> 1], sc[t][nt][i]);
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x = __fmul_rn(sc[t][nt][i], scale);
              sc[t][nt][i] = nt * 8 + (i & 1) < lim ? x : -INFINITY;
              mx[i >> 1] = fmaxf(mx[i >> 1], sc[t][nt][i]);
            }
        }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      // sweep 2: e = exp(s - max), its f32 sum, P.V with e rounded to bf16
      float o[kDh / 8][4] = {};
      float es[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < kRpTiles; ++t) {
        if (t >= ntiles) break;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = expf(sc[t][nt][i] - mx[i >> 1]);  // 0 past n
            es[i >> 1] += x;
            sc[t][nt][i] = x;  // rounded to bf16 as c_to_a packs it
          }
        uint32_t pa[2][4];
        c_to_a(pa, sc[t]);
        warp_pv<kDh, kLd>(o, pa, vs + t * kFbIn * kLd);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float den = quad_sum(es[r]);
        const int row = sl * 16 + (lane >> 2) + 8 * r;
        if (row >= n) continue;
        bf* d = dst + (size_t)row * o_rs;
#pragma unroll
        for (int nd = 0; nd < kDh / 8; ++nd)
          *reinterpret_cast<__nv_bfloat162*>(d + nd * 8 + 2 * cq) =
              __floats2bfloat162_rn(o[nd][2 * r] / den,
                                    o[nd][2 * r + 1] / den);
      }
    }
    turn = (turn + nsl) % kRpWarps;
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(bars + kRpStages + p.s));
    p.next(kRpStages);
  }
}

// ---------------------------------------------------------------------------
// K5 in bf16: the stacks' attention backward on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces, in bf16, the FMA passes attention_bwd_q / _kv (f32 keeps them)
// for the stacks' backward: the port of sketchformer_tpu/ops/
// pallas_packed.py::group_attn_bwd and ln_blocks_bwd32, which run inside
// pallas_encoder_train.py::_layer_bwd_kernel and pallas_decoder_train.py::
// _dec_layer_bwd_kernel. flash_bwd_mma_kernel's design (owned tiles of
// 16-row warps, 32-row tiles of the other side through a cp.async double
// buffer, every product mma.sync m16n8k16 with the score tiles in
// registers) with the stacks' numerics. A block owns 64 or 96 rows (4 or 6
// warps, kWarps), the host's choice for each pass (ops/attention_train.py::
// bwd_owner_rows): 96 where that leaves fewer rows past T and Dh <= 64, so
// T = 96 (the B = 512 training shapes) takes one block a head with no row
// computed past T where 64-row tiles computed a quarter of theirs past it.
//   kDkv false  a block owns query rows. Sweep 1 over the keys forms S
//               and dP = dO.V^T and keeps the online max, sum of exp and
//               sum of exp * dp; delta = that last over the sum (sum_j dp
//               p over every key, the TPU kernel's form). Sweep 2 forms p =
//               e / sum (a division), ds = round(p * (dp - delta)) and dq
//               += ds.K; it stores dq and each row's (max, sum, delta).
//   kDkv true   a block owns key rows and sweeps the queries: S^T, dP^T,
//               p and ds from the saved statistics, dv += round(p)^T.dO and
//               dk += ds^T.Q.
// Scores are scaled, rounded, then take the causal -1e9 and the key bias
// (score()'s order). qk-norm: Q and K arrive pre-norm; the owned tile is
// normalised once in shared memory, each swept tile once a sweep after it
// lands (norm_rows: head_norm's f32 statistics, rounded to bf16). The
// epilogue runs the qk-norm backward on dq / dk from the owned rows'
// xhat and rstd, recomputed from their pre-norm rows. dO is bf16 (cp.async)
// or f32 (rounded while it is staged, as the FMA passes round it); dq, dk
// and dv are stored in f32. The norm parameter gradients: each block's
// partial rows (its warps' sums added in warp order) go to scratch; the
// last block of each batch element adds that element's partials in block
// order and the last of those adds the B sums in order (split_reduce.cuh,
// two levels, so no block reads more than max(H * tiles, B) rows), so no
// sum_rows launch follows. Each output row has one owner and the sums run
// in a fixed order: re-runs are bit-stable. What bounds it: as K8's
// backward, the exponentials (three a score) and the score tiles' register
// traffic, not the products or the bytes.

// rows [row0, row0 + n) of an f32 (T, Dh) pane (row stride rs, rows 16-byte
// aligned) rounded to bf16 into smem rows of kLd elements, by kThreads
// threads; rows past T zero
template <int kLd, int kThreads>
__device__ __forceinline__ void stage_rows_f32(__nv_bfloat16* dst,
                                               const float* src, int rs,
                                               int row0, int n, int T,
                                               int Dh) {
  const int cpr = Dh / 8;
  for (int i = threadIdx.x; i < n * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * rs + c);
      const float4 x = __ldg(p), y = __ldg(p + 1);
      u = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                     pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = u;
  }
}

// the stacks' score of query t and key j (j clamped into the bias row)
__device__ __forceinline__ float k5_score(float acc, const AttnArgs& a,
                                          const float* kb, int t, int j) {
  float s = __fmul_rn(acc, a.scale);
  if (a.causal == 1) s += j <= t ? 0.f : kNegInf;
  if (kb != nullptr) s += kb[min(j, a.Tk - 1)];
  return s;
}

// this thread's two owned rows (row0 + gq + 8 r) of a gradient in C
// fragments (column 8 nd + 2 cq + e) times mul; with ns, through the
// qk-norm backward (head_norm_bwd) from xhat and rstd recomputed from the
// pre-norm rows x, the rows below T adding their dy * xhat and dy into ps /
// pb; stored in f32 for the rows below T
template <int kDh>
__device__ __forceinline__ void store_owned(
    const float (&acc)[kDh / 8][4], float mul, const __nv_bfloat16* x,
    int x_rs, const float* __restrict__ ns, int T, int Dh, int row0,
    float* out, int o_rs, float (&ps)[kDh / 4], float (&pb)[kDh / 4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + gq + 8 * r;
    const bool live = t < T;
    float dy[kDh / 4];
#pragma unroll
    for (int nd = 0; nd < kDh / 8; ++nd) {
      dy[2 * nd] = acc[nd][2 * r] * mul;
      dy[2 * nd + 1] = acc[nd][2 * r + 1] * mul;
    }
    if (ns != nullptr) {
      const __nv_bfloat16* xr = x + (size_t)min(t, T - 1) * x_rs;
      float xh[kDh / 4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int nd = 0; nd < kDh / 8; ++nd) {
        const int c = nd * 8 + 2 * cq;
        float2 v = make_float2(0.f, 0.f);
        if (c < Dh)
          v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xr + c));
        xh[2 * nd] = v.x;
        xh[2 * nd + 1] = v.y;
        s1 += v.x + v.y;
        s2 += v.x * v.x + v.y * v.y;
      }
      const float mu = quad_sum(s1) / Dh;
      const float rstd =
          1.f / sqrtf(fmaxf(quad_sum(s2) / Dh - mu * mu, 0.f) + kLnEps);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < kDh / 4; ++i) {
        const int c = (i >> 1) * 8 + 2 * cq + (i & 1);
        const bool in = c < Dh;
        xh[i] = in ? (xh[i] - mu) * rstd : 0.f;
        if (live && in) {
          ps[i] += dy[i] * xh[i];
          pb[i] += dy[i];
        }
        dy[i] = in ? dy[i] * ns[c] : 0.f;  // dxhat
        m1 += dy[i];
        m2 += dy[i] * xh[i];
      }
      m1 = quad_sum(m1) / Dh;
      m2 = quad_sum(m2) / Dh;
#pragma unroll
      for (int i = 0; i < kDh / 4; ++i)
        dy[i] = rstd * (dy[i] - m1 - xh[i] * m2);
    }
    if (!live) continue;
    float* dst = out + (size_t)t * o_rs;
#pragma unroll
    for (int nd = 0; nd < kDh / 8; ++nd) {
      const int c = nd * 8 + 2 * cq;
      if (c < Dh)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(dy[2 * nd], dy[2 * nd + 1]);
    }
  }
}

// the qk-norm parameter gradients: the block's partial rows (the kWarps
// warps' sums added in warp order; columns past Dh zero) into ws, then the
// two-level fixed-order sum into m.norm_grad (see the note above); red is
// 2 kWarps kDh floats of shared memory no thread reads any more
template <int kDh, int kWarps>
__device__ void norm_grads(const float (&ps)[kDh / 4],
                           const float (&pb)[kDh / 4], float* red,
                           const MmaBwdArgs& m, int Dh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i) {
    float u = ps[i], w = pb[i];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      u += __shfl_xor_sync(0xffffffffu, u, o);
      w += __shfl_xor_sync(0xffffffffu, w, o);
    }
    const int c = (i >> 1) * 8 + 2 * cq + (i & 1);
    if (gq == 0) {
      red[(warp * 2) * kDh + c] = u;
      red[(warp * 2 + 1) * kDh + c] = w;
    }
  }
  __syncthreads();
  const int splits = gridDim.x * gridDim.y, b = blockIdx.z;
  const size_t z = (size_t)b * splits + blockIdx.y * gridDim.x + blockIdx.x;
  for (int i = tid; i < 2 * kDh; i += 32 * kWarps) {
    const int part = i / kDh, c = i % kDh;
    float v = 0.f;
    if (c < Dh)
      for (int w = 0; w < kWarps; ++w) v += red[(w * 2 + part) * kDh + c];
    m.ws[z * 2 * kDh + i] = v;
  }
  __shared__ int flag;
  float* sums = m.ws + (size_t)gridDim.z * splits * 2 * kDh;  // (B, 2, kDh)
  if (!split_last_block(m.counters + b, splits, &flag)) return;
  split_reduce<2, kDh>(m.ws + (size_t)b * splits * 2 * kDh, splits,
                       sums + (size_t)b * 2 * kDh, 2, kDh, 0, 0, nullptr,
                       nullptr);
  if (split_last_block(m.counters + gridDim.z, gridDim.z, &flag))
    split_reduce<2, kDh>(sums, gridDim.z, m.norm_grad, 2, Dh, 0, 0, nullptr,
                         nullptr);
}

// blocks an SM that the register cap allows (at most 102 registers a
// thread at Dh = 32 with 4 warps, 113 with 6; 128 and 170 at Dh = 64; Dh =
// 128 runs 4 warps only)
template <int kDh, int kWarps>
constexpr int bwd_min_blocks() {
  return kDh == 32 ? (kWarps == 4 ? 5 : 3) : kDh == 64 ? (kWarps == 4 ? 4 : 2)
                                                       : 2;
}

template <int kDh, bool kDkv, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, bwd_min_blocks<kDh, kWarps>())
attention_bwd_mma_kernel(AttnArgs a, GradArgs g, MmaBwdArgs m) {
  using bf = __nv_bfloat16;
  constexpr int kLd = kDh + 8, kOwn = 16 * kWarps, kThr = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char k5_smem[];
  bf* own1 = reinterpret_cast<bf*>(k5_smem);  // [kOwn][kLd]: Q (K for dkv)
  bf* own2 = own1 + kOwn * kLd;               //             dO (V)
  bf* inb = own2 + kOwn * kLd;                // [2][2][32][kLd]: K, V (Q, dO)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int r0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int Tow = kDkv ? a.Tk : a.Tq, Tin = kDkv ? a.Tq : a.Tk;
  const bf* q = static_cast<const bf*>(a.q) + b * a.q_bs + h * a.Dh;
  const bf* k = static_cast<const bf*>(a.k) + b * a.k_bs + h * a.Dh;
  const bf* v = static_cast<const bf*>(a.v) + b * a.v_bs + h * a.Dh;
  const size_t do0 = (size_t)b * g.do_bs + h * a.Dh;
  const float* kb = batch_bias(a, b);
  // the owned tile's and the swept tiles' qk-norm parameters
  const float* own_s = kDkv ? a.kn_s : a.qn_s;
  const float* own_b = kDkv ? a.kn_b : a.qn_b;
  const float* in_s = kDkv ? a.qn_s : a.kn_s;
  const float* in_b = kDkv ? a.qn_b : a.kn_b;

  // zero everything once: the columns past Dh are never written again
  for (int i = tid; i < (2 * kOwn + 4 * kFbIn) * kLd / 8; i += kThr)
    reinterpret_cast<uint4*>(k5_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto stage = [&](bf* dst, const bf* src, int rs, int row0, int n, int T) {
    stage_rows<kLd, kThr>(dst, src, rs, row0, n, T, a.Dh);
  };
  auto stage_do = [&](bf* dst, int row0, int n) {
    if (m.do_f32)
      stage_rows_f32<kLd, kThr>(dst, static_cast<const float*>(g.dout) + do0,
                                g.do_rs, row0, n, a.Tq, a.Dh);
    else
      stage(dst, static_cast<const bf*>(g.dout) + do0, g.do_rs, row0, n,
            a.Tq);
  };
  if constexpr (kDkv) {
    stage(own1, k, a.k_rs, r0, kOwn, a.Tk);
    stage(own2, v, a.v_rs, r0, kOwn, a.Tk);
  } else {
    stage(own1, q, a.q_rs, r0, kOwn, a.Tq);
    stage_do(own2, r0, kOwn);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (own_s != nullptr) {
    norm_rows<kDh, kThr>(own1, min(kOwn, Tow - r0), a.Dh, own_s, own_b);
    __syncthreads();
  }

  auto stage_in = [&](bf* dst, int row0) {
    if constexpr (kDkv) {
      stage(dst, q, a.q_rs, row0, kFbIn, a.Tq);
      stage_do(dst + kFbIn * kLd, row0, kFbIn);
    } else {
      stage(dst, k, a.k_rs, row0, kFbIn, a.Tk);
      stage(dst + kFbIn * kLd, v, a.v_rs, row0, kFbIn, a.Tk);
    }
    cp_async_commit();
  };
  const int ntiles = (Tin + kFbIn - 1) / kFbIn;
  // one sweep over the other side: body(tile start, its two smem tiles),
  // the first of them normalised once after it lands
  auto sweep = [&](auto&& body) {
    stage_in(inb, 0);
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) {
        stage_in(inb + ((it + 1) & 1) * 2 * kFbIn * kLd, (it + 1) * kFbIn);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      bf* cb = inb + (it & 1) * 2 * kFbIn * kLd;
      if (in_s != nullptr) {
        norm_rows<kDh, kThr>(cb, min(kFbIn, Tin - it * kFbIn), a.Dh, in_s,
                             in_b);
        __syncthreads();
      }
      body(it * kFbIn, cb, cb + kFbIn * kLd);
      __syncthreads();
    }
  };

  const int row0 = r0 + warp * 16;  // the warp's 16 owned rows
  const int rowA = row0 + gq;       // this thread's: rowA and rowA + 8
  float acc1[kDh / 8][4], acc2[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  float ps[kDh / 4], pb[kDh / 4];
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i) ps[i] = pb[i] = 0.f;

  if constexpr (!kDkv) {
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f},
          sd[2] = {0.f, 0.f};
    sweep([&](int j0, const bf* kt, const bf* vt) {
      float s[4][4], dp[4][4];
      warp_qk<kDh, kLd>(s, own1, kt);
      warp_qk<kDh, kLd>(dp, own2, vt);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = rowA + 8 * (i >> 1), j = j0 + nt * 8 + 2 * cq + (i & 1);
          s[nt][i] = j < a.Tk ? k5_score(s[nt][i], a, kb, t, j) : -INFINITY;
          tmax[i >> 1] = fmaxf(tmax[i >> 1], s[nt][i]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(mx[r], quad_max(tmax[r]));
        float es = 0.f, ed = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 2 * r; i < 2 * r + 2; ++i) {
            const float e = expf(s[nt][i] - mn);
            es += e;
            ed += e * dp[nt][i];
          }
        const float f = expf(mx[r] - mn);  // 0 on the first tile
        sm[r] = sm[r] * f + quad_sum(es);
        sd[r] = sd[r] * f + quad_sum(ed);
        mx[r] = mn;
      }
    });
    const float delta[2] = {sd[0] / sm[0], sd[1] / sm[1]};
    sweep([&](int j0, const bf* kt, const bf* vt) {
      float s[4][4], dp[4][4];
      warp_qk<kDh, kLd>(s, own1, kt);
      warp_qk<kDh, kLd>(dp, own2, vt);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int t = rowA + 8 * r, j = j0 + nt * 8 + 2 * cq + (i & 1);
          const float sv = j < a.Tk ? k5_score(s[nt][i], a, kb, t, j)
                                    : -INFINITY;
          const float p = __fdiv_rn(expf(sv - mx[r]), sm[r]);
          dp[nt][i] = p * (dp[nt][i] - delta[r]);
        }
      uint32_t pa[2][4];
      c_to_a(pa, dp);  // ds rounded to bf16
      warp_pv<kDh, kLd>(acc1, pa, kt);
    });
    store_owned<kDh>(acc1, a.scale, q, a.q_rs, a.qn_s, a.Tq, a.Dh, row0,
                     static_cast<float*>(g.dq) + b * g.dq_bs + h * a.Dh,
                     g.dq_rs, ps, pb);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = rowA + 8 * r;
      if (t < a.Tq && cq == 0) {
        float* st = g.stats + (((size_t)b * a.H + h) * a.Tq + t) * 3;
        st[0] = mx[r];
        st[1] = sm[r];
        st[2] = delta[r];
      }
    }
  } else {
    const float* stats = g.stats + ((size_t)b * a.H + h) * a.Tq * 3;
    sweep([&](int t0, const bf* qt, const bf* dot) {
      float s[4][4], dp[4][4];
      warp_qk<kDh, kLd>(s, own1, qt);
      warp_qk<kDh, kLd>(dp, own2, dot);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = rowA + 8 * (i >> 1), t = t0 + nt * 8 + 2 * cq + (i & 1);
          float p = 0.f, ds = 0.f;
          if (t < a.Tq) {
            const float* st = stats + (size_t)t * 3;
            p = __fdiv_rn(expf(k5_score(s[nt][i], a, kb, t, j) - st[0]),
                          st[1]);
            ds = p * (dp[nt][i] - st[2]);
          }
          s[nt][i] = p;
          dp[nt][i] = ds;
        }
      uint32_t pa[2][4];
      c_to_a(pa, s);                      // p rounded to bf16
      warp_pv<kDh, kLd>(acc2, pa, dot);   // dv += p^T . dO
      c_to_a(pa, dp);                     // ds rounded to bf16
      warp_pv<kDh, kLd>(acc1, pa, qt);    // dk += ds^T . Q
    });
    float none[kDh / 4], none_b[kDh / 4];
    store_owned<kDh>(acc2, 1.f, v, a.v_rs, nullptr, a.Tk, a.Dh, row0,
                     static_cast<float*>(g.dv) + b * g.dv_bs + h * a.Dh,
                     g.dv_rs, none, none_b);
    store_owned<kDh>(acc1, a.scale, k, a.k_rs, a.kn_s, a.Tk, a.Dh, row0,
                     static_cast<float*>(g.dk) + b * g.dk_bs + h * a.Dh,
                     g.dk_rs, ps, pb);
  }
  if (own_s != nullptr)
    norm_grads<kDh, kWarps>(ps, pb, reinterpret_cast<float*>(inb), m, a.Dh);
}

// the bf16 backward's shapes: Dh a multiple of 16 up to 128, q / k / v and
// dO rows 16-byte aligned, the f32 gradients' rows 8-byte aligned
bool bwd_mma_shapes_ok(const AttnArgs& a, const GradArgs& g,
                       const MmaBwdArgs& m) {
  auto al = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int do_al = m.do_f32 ? 4 : 8;  // elements in 16 bytes
  return a.Dh % 16 == 0 && a.Dh <= 128 && al(a.q, 16) && al(a.k, 16) &&
         al(a.v, 16) && al(g.dout, 16) &&
         (a.q_rs | a.k_rs | a.v_rs | a.q_bs | a.k_bs | a.v_bs) % 8 == 0 &&
         (g.do_rs % do_al | g.do_bs % do_al) == 0 && al(g.dq, 8) &&
         al(g.dk, 8) && al(g.dv, 8) &&
         (g.dq_rs | g.dk_rs | g.dv_rs | g.dq_bs | g.dk_bs | g.dv_bs) % 2 == 0 &&
         (a.qn_s == nullptr || (m.ws != nullptr && m.counters != nullptr &&
                                m.norm_grad != nullptr));
}

template <int kDh, int kWarps>
int launch_bwd_mma_dh(int pass, const AttnArgs& a, const GradArgs& g,
                      const MmaBwdArgs& m, int B, cudaStream_t stream) {
  constexpr int kOwn = 16 * kWarps;
  const size_t smem = (size_t)(2 * kOwn + 4 * kFbIn) * (kDh + 8) * 2;
  auto kernel = pass == 1 ? attention_bwd_mma_kernel<kDh, false, kWarps>
                          : attention_bwd_mma_kernel<kDh, true, kWarps>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int T = pass == 1 ? a.Tq : a.Tk;
  kernel<<<dim3((T + kOwn - 1) / kOwn, a.H, B), 32 * kWarps, smem,
           stream>>>(a, g, m);
  return (int)cudaGetLastError();
}

// m.own_rows: 64 or 96 rows a block (4 or 6 warps), the host's choice;
// 96 only at Dh <= 64, the pairs ops/attention_train.py::bwd_owner_rows
// selects
template <int kDh>
int launch_bwd_mma_own(int pass, const AttnArgs& a, const GradArgs& g,
                       const MmaBwdArgs& m, int B, cudaStream_t s) {
  if (m.own_rows == 64) return launch_bwd_mma_dh<kDh, 4>(pass, a, g, m, B, s);
  if constexpr (kDh <= 64) {
    if (m.own_rows == 96) return launch_bwd_mma_dh<kDh, 6>(pass, a, g, m, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_bwd_mma(int pass, const AttnArgs& a, const GradArgs& g,
                   const MmaBwdArgs& m, int B, cudaStream_t s) {
  if (!bwd_mma_shapes_ok(a, g, m)) return (int)cudaErrorInvalidValue;
  if (a.Dh <= 32) return launch_bwd_mma_own<32>(pass, a, g, m, B, s);
  if (a.Dh <= 64) return launch_bwd_mma_own<64>(pass, a, g, m, B, s);
  return launch_bwd_mma_own<128>(pass, a, g, m, B, s);
}

// the f32 FMA forward (bf16 runs launch_fwd_mma)
template <typename T, int NI>
int launch_fwd(const AttnArgs& a, void* out, long long o_bs, int o_rs,
               int norm_p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kFwdQT * a.Dh +
                                       (size_t)kFwdQT * a.Tk +
                                       (size_t)kKC * (a.Dh + 1));
  const dim3 grid((a.Tq + kFwdQT - 1) / kFwdQT, a.H, B);
  auto kernel = norm_p ? attention_fwd_kernel<T, NI, true>
                       : attention_fwd_kernel<T, NI, false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a, static_cast<T*>(out), o_bs, o_rs);
  return (int)cudaGetLastError();
}

template <typename T, int NI>
int launch_bwd_q(const AttnArgs& a, const GradArgs& g, int B,
                 cudaStream_t stream) {
  // the qk-norm partials need kWarps * 2 * Dh floats of the score panes
  const size_t panes = std::max((size_t)kBwdQT * a.Tk * 2,
                                (size_t)2 * kWarps * a.Dh);
  const size_t smem = sizeof(float) * ((size_t)2 * kBwdQT * a.Dh + panes +
                                       (size_t)kKC * (a.Dh + 1));
  const dim3 grid((a.Tq + kBwdQT - 1) / kBwdQT, a.H, B);
  int err = set_smem(attention_bwd_q_kernel<T, NI>, smem);
  if (err) return err;
  attention_bwd_q_kernel<T, NI><<<grid, kThreads, smem, stream>>>(a, g);
  return (int)cudaGetLastError();
}

template <typename T, int NI>
int launch_bwd_kv(const AttnArgs& a, const GradArgs& g, int B,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      ((size_t)2 * kKT * a.Dh + (size_t)2 * kQC * (a.Dh + 1) +
                       (size_t)kQC * 3 + (size_t)2 * kKT * kQC);
  const dim3 grid((a.Tk + kKT - 1) / kKT, a.H, B);
  int err = set_smem(attention_bwd_kv_kernel<T, NI>, smem);
  if (err) return err;
  attention_bwd_kv_kernel<T, NI><<<grid, kThreads, smem, stream>>>(a, g);
  return (int)cudaGetLastError();
}

// f32: Dh <= 32 * NI; which pass: 0 fwd, 1 bwd_q, 2 bwd_kv
template <typename T>
int dispatch(int pass, const AttnArgs& a, const GradArgs& g, void* out,
             long long o_bs, int o_rs, int norm_p, int B,
             cudaStream_t stream) {
#define SK_PASS(NI)                                                      \
  return pass == 0   ? launch_fwd<T, NI>(a, out, o_bs, o_rs, norm_p, B, \
                                       stream)                           \
         : pass == 1 ? launch_bwd_q<T, NI>(a, g, B, stream)              \
                     : launch_bwd_kv<T, NI>(a, g, B, stream);
  if (a.Dh <= 32) { SK_PASS(1) }
  if (a.Dh <= 64) { SK_PASS(2) }
  if (a.Dh <= 128) { SK_PASS(4) }
#undef SK_PASS
  return (int)cudaErrorInvalidValue;
}

bool args_ok(const AttnArgs& a) {
  return a.Tq >= 1 && a.Tk >= 1 && a.Dh >= 1 &&
         (a.causal != 1 || a.Tq == a.Tk);
}

// f32 any pass on the FMA kernels; bf16 the tensor-core forward (the bf16
// backward passes are launched by sk_attention_bwd)
int dispatch_dtype(int dtype, int pass, const AttnArgs& a, const GradArgs& g,
                   void* out, long long o_bs, int o_rs, int norm_p, int B,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(pass, a, g, out, o_bs, o_rs, norm_p, B, s);
  if (dtype == 1 && pass == 0)
    return launch_fwd_mma(a, out, o_bs, o_rs, norm_p, 0, B, s);
  return (int)cudaErrorInvalidValue;
}

AttnArgs make_args(const void* q, long long q_bs, int q_rs, const void* k,
                   long long k_bs, int k_rs, const void* v, long long v_bs,
                   int v_rs, const void* bias, long long bias_bs, int bias_rs,
                   const void* qn_s, const void* qn_b, const void* kn_s,
                   const void* kn_b, int Tq, int Tk, int H, int Dh,
                   int causal, int recip, float scale) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v;
  a.q_bs = q_bs; a.k_bs = k_bs; a.v_bs = v_bs;
  a.q_rs = q_rs; a.k_rs = k_rs; a.v_rs = v_rs;
  a.bias = static_cast<const float*>(bias);
  a.bias_bs = bias_bs; a.bias_rs = bias_rs;
  a.qn_s = static_cast<const float*>(qn_s);
  a.qn_b = static_cast<const float*>(qn_b);
  a.kn_s = static_cast<const float*>(kn_s);
  a.kn_b = static_cast<const float*>(kn_b);
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.Dh = Dh; a.causal = causal;
  a.recip = recip;
  a.scale = scale;
  a.work = nullptr;
  return a;
}

GradArgs make_grads(const void* dout, long long do_bs, int do_rs,
                    void* stats, void* dq, long long dq_bs, int dq_rs,
                    void* dk, long long dk_bs, int dk_rs, void* dv,
                    long long dv_bs, int dv_rs, void* part_s, void* part_b,
                    int io_dt) {
  GradArgs g;
  g.dout = dout;
  g.do_bs = do_bs;
  g.do_rs = do_rs;
  g.stats = static_cast<float*>(stats);
  g.dq = dq; g.dk = dk; g.dv = dv;
  g.dq_bs = dq_bs; g.dk_bs = dk_bs; g.dv_bs = dv_bs;
  g.dq_rs = dq_rs; g.dk_rs = dk_rs; g.dv_rs = dv_rs;
  g.part_s = static_cast<float*>(part_s);
  g.part_b = static_cast<float*>(part_b);
  g.io_dt = io_dt;
  return g;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Strides are in elements; each
// pointer is the first element of head 0 of batch element 0.
extern "C" {

// the training stacks' attention: a (B, Tk) key bias, causal added before
// it, f32 gradients; dO in f32 or (do_dt) the compute dtype. resident (bf16
// only) runs the forward's whole-head variant
int sk_attention_fwd(int dtype, const void* q, long long q_bs, int q_rs,
                     const void* k, long long k_bs, int k_rs, const void* v,
                     long long v_bs, int v_rs, const void* key_bias,
                     const void* qn_s, const void* qn_b, const void* kn_s,
                     const void* kn_b, void* out, long long o_bs, int o_rs,
                     int B, int Tq, int Tk, int H, int Dh, int causal,
                     int norm_p, int resident, float scale, void* stream) {
  const AttnArgs a = make_args(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs,
                               key_bias, Tk, 0, qn_s, qn_b, kn_s, kn_b, Tq,
                               Tk, H, Dh, causal ? 1 : 0, 0, scale);
  if (resident) {
    if (dtype != 1 || !args_ok(a)) return (int)cudaErrorInvalidValue;
    return launch_fwd_mma(a, out, o_bs, o_rs, norm_p, 1, B,
                          static_cast<cudaStream_t>(stream));
  }
  GradArgs g = {};
  return dispatch_dtype(dtype, 0, a, g, out, o_bs, o_rs, norm_p, B, stream);
}

// the inference encoder stack's attention on packed rows, bf16 only: q, k
// and v hold every sketch's valid rows back to back (row strides q_rs, k_rs,
// v_rs); work (W, 3) int32 lists a (first query row, sketch's first row,
// sketch's length) triple a 64-row query block; T is the longest sketch.
// No bias, the unnormalised e rounded (encoder_attention's numerics);
// resident runs the whole-head variant
int sk_attention_fwd_ragged(const void* q, int q_rs, const void* k, int k_rs,
                            const void* v, int v_rs, const void* qn_s,
                            const void* qn_b, const void* kn_s,
                            const void* kn_b, const void* work, int W,
                            void* out, int o_rs, int T, int H, int Dh,
                            int resident, float scale, void* stream) {
  AttnArgs a = make_args(q, 0, q_rs, k, 0, k_rs, v, 0, v_rs, nullptr, 0, 0,
                         qn_s, qn_b, kn_s, kn_b, T, T, H, Dh, 0, 0, scale);
  a.work = static_cast<const int*>(work);
  if (!args_ok(a) || W < 1 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_mma(a, out, 0, o_rs, 0, resident, 1,
                        static_cast<cudaStream_t>(stream), W);
}

// the same attention as the persistent walk over (sketch, head) items
// (ragged_attention_fwd_mma_kernel): bf16, Dh = 32, no qk-norm; q, k and v
// as above with one row stride rs; items (B, 2) int32 holds each sketch's
// (first row, length) in the walk's order; T is the longest sketch, at most
// kRpRows; grid blocks, at most sk_ragged_fit's blocks an SM times the SMs
int sk_attention_fwd_ragged_persistent(const void* q, const void* k,
                                       const void* v, int rs,
                                       const void* items, int B, void* out,
                                       int o_rs, int T, int H, int Dh,
                                       float scale, int grid, void* stream) {
  using bf = __nv_bfloat16;
  auto al = [](const void* p, unsigned n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (Dh != kRpDh || T < 1 || T > kRpRows || B < 1 || H < 1 || grid < 1 ||
      (long long)B * H >= (1ll << 31) || rs % 8 || o_rs % 2 || !al(q, 16) ||
      !al(k, 16) || !al(v, 16) || !al(items, 8) || !al(out, 4))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem(ragged_attention_fwd_mma_kernel, kRpSmem);
  if (err) return err;
  ragged_attention_fwd_mma_kernel<<<grid, kRpThreads, kRpSmem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), rs, static_cast<const int2*>(items), B * H,
      H, scale, static_cast<bf*>(out), o_rs);
  return (int)cudaGetLastError();
}

// the persistent ragged kernel's resident blocks an SM (its grid's size)
int sk_ragged_fit(int* blocks) {
  const int err = set_smem(ragged_attention_fwd_mma_kernel, kRpSmem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ragged_attention_fwd_mma_kernel, kRpThreads, kRpSmem);
}

// the qk-norm parameter gradients: f32 writes per-block partial rows to
// part_s / part_b (summed by sum_rows); bf16 sums them in the launch into
// norm_grad (2, Dh) through ws and counters, with own_rows (64 or 96) owned
// rows a block (see attention_bwd_mma_kernel)
int sk_attention_bwd(int dtype, int pass, const void* q, long long q_bs,
                     int q_rs, const void* k, long long k_bs, int k_rs,
                     const void* v, long long v_bs, int v_rs,
                     const void* key_bias, const void* qn_s, const void* qn_b,
                     const void* kn_s, const void* kn_b, const void* dout,
                     long long do_bs, int do_rs, int do_dt, void* stats,
                     void* dq, long long dq_bs, int dq_rs, void* dk,
                     long long dk_bs, int dk_rs, void* dv, long long dv_bs,
                     int dv_rs, void* part_s, void* part_b, void* norm_grad,
                     void* ws, void* counters, int own_rows, int B, int Tq,
                     int Tk, int H, int Dh, int causal, float scale,
                     void* stream) {
  if (pass != 1 && pass != 2) return (int)cudaErrorInvalidValue;
  const AttnArgs a = make_args(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs,
                               key_bias, Tk, 0, qn_s, qn_b, kn_s, kn_b, Tq,
                               Tk, H, Dh, causal ? 1 : 0, 0, scale);
  const GradArgs g = make_grads(dout, do_bs, do_rs, stats, dq, dq_bs, dq_rs,
                                dk, dk_bs, dk_rs, dv, dv_bs, dv_rs, part_s,
                                part_b, 0);
  if (dtype != 1)
    return dispatch_dtype(dtype, pass, a, g, nullptr, 0, 0, 0, B, stream);
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  MmaBwdArgs m;
  m.do_f32 = !do_dt;
  m.own_rows = own_rows;
  m.ws = static_cast<float*>(ws);
  m.norm_grad = static_cast<float*>(norm_grad);
  m.counters = static_cast<unsigned*>(counters);
  return launch_bwd_mma(pass, a, g, m, B, static_cast<cudaStream_t>(stream));
}

// K8: a bias of row stride bias_rs and batch stride bias_bs (or null),
// causal as a where() after it, no qk-norm; the forward rounds the
// unnormalised e and divides after
int sk_flash_attention_fwd(int dtype, const void* q, long long q_bs, int q_rs,
                           const void* k, long long k_bs, int k_rs,
                           const void* v, long long v_bs, int v_rs,
                           const void* bias, long long bias_bs, int bias_rs,
                           void* out, long long o_bs, int o_rs, int B, int Tq,
                           int Tk, int H, int Dh, int causal, float scale,
                           void* stream) {
  const AttnArgs a = make_args(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs,
                               bias, bias_bs, bias_rs, nullptr, nullptr,
                               nullptr, nullptr, Tq, Tk, H, Dh,
                               causal ? 2 : 0, 1, scale);
  GradArgs g = {};
  return dispatch_dtype(dtype, 0, a, g, out, o_bs, o_rs, 0, B, stream);
}

// K8's backward: dq, dk, dv (and each row's (max, sum, delta) in stats);
// dO and the gradients in the compute dtype. bf16 runs the tensor-core
// kernel's two launches (Dh a multiple of 8, rows 16-byte aligned); f32 the
// FMA passes of attention_bwd_q / _kv
int sk_flash_attention_bwd(int dtype, const void* q, long long q_bs, int q_rs,
                           const void* k, long long k_bs, int k_rs,
                           const void* v, long long v_bs, int v_rs,
                           const void* bias, long long bias_bs, int bias_rs,
                           const void* dout, long long do_bs, int do_rs,
                           void* stats, void* dq, long long dq_bs, int dq_rs,
                           void* dk, long long dk_bs, int dk_rs, void* dv,
                           long long dv_bs, int dv_rs, int B, int Tq, int Tk,
                           int H, int Dh, int causal, float scale,
                           void* stream) {
  const AttnArgs a = make_args(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs,
                               bias, bias_bs, bias_rs, nullptr, nullptr,
                               nullptr, nullptr, Tq, Tk, H, Dh,
                               causal ? 2 : 0, 1, scale);
  const GradArgs g = make_grads(dout, do_bs, do_rs, stats, dq, dq_bs, dq_rs,
                                dk, dk_bs, dk_rs, dv, dv_bs, dv_rs, nullptr,
                                nullptr, 1);
  if (dtype == 0) {
    const int err = dispatch_dtype(0, 1, a, g, nullptr, 0, 0, 0, B, stream);
    if (err) return err;
    return dispatch_dtype(0, 2, a, g, nullptr, 0, 0, 0, B, stream);
  }
  if (dtype != 1 || Tq < 1 || Tk < 1 || Dh < 1 || Dh % 8 != 0 ||
      (q_rs | k_rs | v_rs | do_rs | dq_rs | dk_rs | dv_rs) % 8 != 0 ||
      (q_bs | k_bs | v_bs | do_bs | dq_bs | dk_bs | dv_bs) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 32) return launch_flash_bwd_mma<32>(a, g, B, s);
  if (Dh <= 64) return launch_flash_bwd_mma<64>(a, g, B, s);
  if (Dh <= 128) return launch_flash_bwd_mma<128>(a, g, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
