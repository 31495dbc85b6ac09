// Hopper (sm_90a) kernels for greedy AR decode: K whole decode steps of a
// batch in one launch, token mode (decode_chunk) and MDN mode
// (decode_cont_chunk).
//
// Replaces the TPU kernels sketchformer_tpu/ops/pallas_decode_loop.py::
// fused_decode_chunk (body _loop_kernel, trunk _trunk_and_ln) and
// fused_decode_cont_chunk (_cont_loop_kernel), and their lane-packed
// small-head variants sketchformer_tpu/ops/pallas_decode_packed.py::
// fused_decode_chunk_packed / fused_decode_cont_chunk_packed. The packed
// variants exist only for the TPU's 128 lanes; here head_dim is an
// argument (Dh <= 128: a warp holds a head row in at most 4 values per
// lane), so one kernel serves H=8/Dh=32 and H=2/Dh=128 alike.
//
// Each step of each batch row: the input embedding (token table row, or
// the Dense(5 -> d) of the previous stroke row) times sqrt(d) plus the
// position row; L pre-LN decoder layers (self-attention against the
// layer's k/v cache, cross-attention against the precomputed bottleneck
// K/V, FFN); the final LayerNorm; the head. Token mode fuses the (d, V)
// vocab product with the masked first-index argmax, so logits are never
// stored; MDN mode takes the greedy component and pen state. Finished
// rows still compute and write their cache rows, and emit PAD (token) or
// PEN_END with zero xy and valid 0 (MDN).
//
// Two designs share the numerics below. float32 (and any bf16 geometry the
// plan declines) runs the per-row kernel, decode_chunk_kernel: a block of 8
// warps owns R batch rows (R = 1 while the batch fits the SMs, else 2) for
// all K steps and L layers, activations in shared memory, the caches in
// device memory (the new k/v row of each layer and step is written straight
// into the cache, where the next step reads it back), and every product a
// matrix-vector product on the FMA units that reads the whole (K, N) weight
// from L2 for R multiply-adds per weight. That is latency-bound: ~15.6 MB
// of weights a block a step at the ar_decode width (PERF.md section 6, the
// K9 and K10 rows, has its times). Its products load 16-byte weight
// vectors kUnroll rows ahead and split the inner dimension across threads
// when a product has few columns; the attention reads 16-byte k/v vectors.
//
// bfloat16 runs decode_cluster_kernel: the batch is the products' rows, as
// in the TPU kernel, where the flagship B=64 is one grid cell and each
// product one (B x d).(d x N) MXU matmul. A thread block cluster of C
// blocks (16, or 8) owns a group of G rows (a multiple of 16) for all K
// steps and L layers; each block owns 1/C of the columns of every product
// and of the head (whole 16-column tiles, ops/decode_chunk.py::
// split_columns) and computes its (G x K).(K x N/C) slice on the tensor
// cores (mma.sync m16n8k16, f32 accumulators, the inner dimension split
// across warps when a slice has few tiles). So a step reads each weight
// once a cluster instead of once a row. The block's slices (~1 MB a step
// at C = 16) and their biases and LayerNorm / qk-norm parameters stream
// through a ring of 2-3 shared-memory slots as TMA boxes and bulk copies,
// which warp 0 issues one copy a lane while the cluster barrier of the
// phase before waits, and which land on the slot's mbarrier. Activations
// stay in shared memory: every block holds the group's residual stream and
// LayerNorm output (exact bf16 values) and copies its slice of each
// product's output into every block of the cluster (16-byte
// st.shared::cluster), and one cluster barrier (arrive.release /
// wait.acquire) completes the rows: 8 a layer and one for the head's pick.
// The QKV and cross-q values go, in f32, only to the block that owns their
// (row, head) pair (pair_owner), which applies qk-norm, writes the pair's
// rounded k/v row into the cache, attends (one warp a pair, the same warp
// every step, so the row it reads back is the one it wrote; its cache
// rows prefetched into L2 at the layer's start) and copies the output row
// to every block. The token head's pick is a (value, index) argmax of each
// block's vocab slice, reduced across the cluster by the first-index rule
// (better()); the MDN head's 6M+3 values are gathered to whole rows first.
// Every block then makes the same pick and embeds the next step itself.
// What bounds it on the card is latency, not bytes or operations: a step
// is a serial chain of ~60 phases (LayerNorm, product, attention, each
// ended by a cluster barrier of ~0.5 us alone), each a short dependent
// chain of a few warps; at B=512 the attention's k/v cache reads too
// (PERF.md section 6, the K9 and K10 rows).
//
// Numerics follow the TPU kernel's rounding sites (pallas_decode_loop.py
// :183, :236, :257-259, :337-338, :546-547): every product accumulates in
// f32, has its f32 bias added, and only then is rounded to the compute
// dtype; LayerNorm is f32 (var = max(E[x^2] - mu^2, 0), eps 1e-6) and
// rounded after; qk-norm stays f32 until the product that reads it;
// attention multiplies dtype values elementwise (each product rounded to
// the dtype) and sums in f32; self-attention rounds the unnormalised
// exponentials before P.V and divides by the f32 sum after, while
// cross-attention rounds the normalised weights; the token head is
// dt(h.W) + f32 bias (PAD and SOS folded into the bias as -1e9), the MDN
// head dt(dt(h.W) + dt(bias)). The one difference is the softmax of the
// self-attention: the TPU kernel runs it online over 128-row cache tiles,
// this kernel over the whole filled row with one max.
//
// decode_step is K13, sketchformer_tpu/ops/pallas_decode_stack.py::
// fused_decode_step (_step_kernel): one whole L-layer step of an embedded
// (B, d) input at position t, returning the final LayerNorm's output and
// each layer's new k/v row (L, B*H, Dh) for the caller to scatter; the
// caches are only read, rows [0, t). Its one numerical difference from the
// chunk trunk is the TPU kernel's: the new position enters the
// self-attention from its f32 values before any rounding (s_new = q.kn and
// e_new * vn in f32, o = (ctx + e_new * vn) / denom), where the chunk
// kernels attend to the rounded row they wrote into the cache. In bf16 it
// is the cluster kernel's third kind (kKindStep): the group's rows read
// from the (B, d) input in place of the embedding, one step of the L
// layers, each pair's owner warp writing the new row (rounded) to k_new /
// v_new and attending to it from the f32 values it holds, no head and no
// pick, the final LayerNorm's output written out; the TPU kernel, too,
// makes the batch pane its products' rows (pallas_decode_stack.py:176-247).
// f32 and declined geometries run the per-row kernel's trunk<..., kStep>.
// Only the step loop of ops/decode_step.py (and the probe it ports) drives
// it: the chunk kernels superseded it on the TPU.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <limits.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;    // weight rows loaded ahead in the products
constexpr int kMaxNI = 4;     // head_dim <= 128: 4 values per lane
constexpr int kMaxSplit = 8;  // inner-dimension slices of one product
constexpr int kNumWeights = 26;

// The stacked decoder weights, in the order of decode_chunk.py's
// TRUNK_KEYS (the JAX kernel's _LOOP_WKEYS). Products' weights are in the
// compute dtype, (L, K, N) row-major; everything else is f32.
template <typename T>
struct Trunk {
  const float *ln1s, *ln1b;
  const T* s_wqkv;
  const float* s_bqkv;
  const float *s_qns, *s_qnb, *s_kns, *s_knb;
  const T* s_wo;
  const float* s_bo;
  const float *ln2s, *ln2b;
  const T* c_wq;
  const float* c_bq;
  const float *c_qns, *c_qnb;
  const T* c_wo;
  const float* c_bo;
  const float *ln3s, *ln3b;
  const T* w1;
  const float* b1;
  const T* w2;
  const float* b2;
  const float *lnfs, *lnfb;
};
static_assert(sizeof(Trunk<float>) == kNumWeights * sizeof(void*),
              "Trunk must be the pointer array");

template <typename T>
struct Args {
  Trunk<T> w;
  T* kc;              // (L, B*H, Tmax, Dh): rows [t0, t0 + K) written
  T* vc;
  const T* ck;        // (L, B*H, Mq, Dh) cross K (qk-normed) and V
  const T* cv;
  const T* pos;       // (K, d) position rows t0 .. t0 + K - 1
  const T* head_w;    // (d, N)
  const float* head_b;  // (N,)
  const T* in_w;      // token: (V, d) table; MDN: (5, d) kernel
  const float* in_b;  // MDN: (d,) bias
  const int* prev_tok;     // (B,) token mode
  const float* prev_row;   // (B, 5) MDN mode
  const int* fin_in;       // (B,)
  int* ids;                // (B, K) token mode
  float* xy;               // (B, K, 2) MDN mode
  int* pen;                // (B, K)
  int* valid;              // (B, K)
  int* fin_out;            // (B,)
  const T* x_in;           // decode_step: (B, d) embedded input
  T* h_out;                // decode_step: (B, d) final LayerNorm output
  T* k_new;                // decode_step: (L, B*H, Dh) new cache rows
  T* v_new;
  int B, L, H, Dh, d, dff, Tmax, Mq, K, t0, N, qk_norm;
  int pad_id, eos_id, M, pen_end;
  int vocab;               // token: the embedding table's rows
  float scale, sqrt_d;
};

// dims array of the C entry point, in this order
enum {
  kB, kL, kH, kDh, kD, kDff, kTmax, kMq, kK, kT0, kN, kQkNorm,
  kPad, kEos, kM, kPenEnd, kVocab, kNumDims
};

// Shared memory, in floats: the residual stream xs, the LayerNorm output
// hs, big (qkv / cross q / FFN hidden / MDN head), the attention output os,
// one score row per (row, head) pair, and the partial sums of a split
// product.
struct Smem {
  int xs, hs, big, os, sc, red, total;
  __host__ __device__ Smem(int R, int d, int dff, int H, int Dh, int Tmax,
                           int Mq, int nbig) {
    const int HD = H * Dh;
    int wide = 3 * HD > dff ? 3 * HD : dff;
    wide = wide > nbig ? wide : nbig;
    const int trow = Tmax > Mq ? Tmax : Mq;
    xs = 0;
    hs = xs + R * d;
    big = hs + R * d;
    os = big + R * wide;
    sc = os + R * HD;
    red = sc + R * H * trow;
    total = red + kMaxSplit * R * kThreads;
  }
};

template <typename T, int CW>
__device__ __forceinline__ void load_w(const T* __restrict__ p,
                                       float (&w)[CW]) {
  if constexpr (CW == 1) {
    w[0] = to_f<T>(__ldg(p));
  } else {
    constexpr int kBytes = CW * (int)sizeof(T);
    using V = typename std::conditional<
        kBytes == 16, uint4,
        typename std::conditional<kBytes == 8, uint2, unsigned>::type>::type;
    const V v = __ldg(reinterpret_cast<const V*>(p));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int c = 0; c < CW; ++c) w[c] = to_f<T>(e[c]);
  }
}

// epi(r, n, sum_k src[r * lds + k] * W[k * N + n]) for every r < R and
// n < N, with CW columns per thread. When the product has fewer column
// groups than threads, the inner dimension is split into S slices whose
// partial sums meet in `red`. Ends with a block barrier.
template <typename T, int R, int CW, typename Epi>
__device__ void block_matmul(const T* __restrict__ W, int Kd, int N,
                             const float* __restrict__ src, int lds,
                             float* __restrict__ red, Epi epi) {
  const int NG = N / CW;
  int S = kThreads / NG;
  S = S < 1 ? 1 : (S > kMaxSplit ? kMaxSplit : S);
  const int KS = (Kd + S - 1) / S;
  for (int it = threadIdx.x; it < NG * S; it += kThreads) {
    const int g = it % NG, s = it / NG, n0 = g * CW;
    const int k0 = s * KS, k1 = min(Kd, k0 + KS);
    float acc[R][CW];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
    const T* wp = W + n0;
#pragma unroll kUnroll
    for (int k = k0; k < k1; ++k) {
      float wv[CW];
      load_w<T, CW>(wp + (size_t)k * N, wv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = src[r * lds + k];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        if (S == 1)
          epi(r, n0 + c, acc[r][c]);
        else
          red[(s * R + r) * N + n0 + c] = acc[r][c];
      }
  }
  if (S > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      float v = 0.f;
      for (int s = 0; s < S; ++s) v += red[(s * R + r) * N + n];
      epi(r, n, v);
    }
  }
  __syncthreads();
}

// block_matmul with the widest column vector that N and alignment allow
template <typename T, int R, typename Epi>
__device__ void matmul(const T* __restrict__ W, int Kd, int N,
                       const float* __restrict__ src, int lds,
                       float* __restrict__ red, Epi epi) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (aligned && N % VW == 0) {
    block_matmul<T, R, VW>(W, Kd, N, src, lds, red, epi);
  } else if constexpr (VW > 4) {
    if (reinterpret_cast<uintptr_t>(W) % 8 == 0 && N % 4 == 0)
      block_matmul<T, R, 4>(W, Kd, N, src, lds, red, epi);
    else
      block_matmul<T, R, 1>(W, Kd, N, src, lds, red, epi);
  } else {
    block_matmul<T, R, 1>(W, Kd, N, src, lds, red, epi);
  }
}

// dst[r] = dt(LN(src[r])) over D values, one warp per row
template <typename T, int R>
__device__ void block_ln(const float* __restrict__ src,
                         float* __restrict__ dst, int D,
                         const float* __restrict__ s,
                         const float* __restrict__ b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kWarps) {
    const float* x = src + r * D;
    float sum = 0.f, ss = 0.f;
    for (int n = lane; n < D; n += 32) {
      sum += x[n];
      ss += x[n] * x[n];
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mu = sum / D;
    const float rstd = 1.f / sqrtf(fmaxf(ss / D - mu * mu, 0.f) + kLnEps);
    for (int n = lane; n < D; n += 32)
      dst[r * D + n] = round_dt<T>((x[n] - mu) * rstd * s[n] + b[n]);
  }
  __syncthreads();
}

// per-head LayerNorm (qk-norm) in place over the Dh-wide head segments of
// R rows of width ld; the result stays f32
template <int R>
__device__ void head_ln(float* base, int ld, int H, int Dh,
                        const float* __restrict__ s,
                        const float* __restrict__ b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int seg = warp; seg < R * H; seg += kWarps) {
    float* x = base + (seg / H) * ld + (seg % H) * Dh;
    float sum = 0.f, ss = 0.f;
    for (int n = lane; n < Dh; n += 32) {
      sum += x[n];
      ss += x[n] * x[n];
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mu = sum / Dh;
    const float rstd = 1.f / sqrtf(fmaxf(ss / Dh - mu * mu, 0.f) + kLnEps);
    for (int n = lane; n < Dh; n += 32)
      x[n] = (x[n] - mu) * rstd * s[n] + b[n];
  }
  __syncthreads();
}

// One warp: attention of one query (Dh f32 values in shared memory, rounded
// to the dtype on use) over n positions of a (n, Dh) k and v block.
// Self-attention (normalized = false) rounds the unnormalised exponentials
// and divides by their sum after P.V; cross-attention (normalized = true)
// rounds the normalised weights. The output is rounded to the dtype, as
// the out-projection reads it. The scores take one position per lane. With
// ``vec`` (16-byte aligned rows whose Dh / VW is a power of two), P.V takes
// 32 / (Dh / VW) positions per warp step, each row read as 16-byte vectors
// by Dh / VW lanes, and the partial sums meet in a butterfly; otherwise the
// lanes take the head dimensions and walk the positions one by one. With
// ``kn`` / ``vn`` (f32 rows in shared memory), one more position follows
// the n, in f32 throughout (decode_step's new position). kSU / kPU unroll
// the score and P.V loops (more loads in flight a lane); kTwoSums adds a
// bf16 score's even and odd products in two f32 chains; kVec compiles the
// vector path alone (the caller guarantees it).
template <typename T, int kSU = 1, int kPU = 4, bool kTwoSums = false,
          bool kVec = false>
__device__ void attend(const float* __restrict__ q, const T* k, const T* v,
                       int n, int Dh, float scale, bool normalized, int vec_,
                       float* __restrict__ sc, float* __restrict__ o,
                       const float* __restrict__ kn = nullptr,
                       const float* __restrict__ vn = nullptr) {
  const int lane = threadIdx.x & 31;
  constexpr int VW = 16 / sizeof(T);
  const int vec = kVec ? 1 : vec_;
#pragma unroll kSU
  for (int p = lane; p < n; p += 32) {
    const T* kp = k + (size_t)p * Dh;
    float s = 0.f, s2 = 0.f;
    if (vec) {
      for (int d0 = 0; d0 < Dh; d0 += VW) {
        const uint4 u = *reinterpret_cast<const uint4*>(kp + d0);
        const T* e = reinterpret_cast<const T*>(&u);
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          // round_dt(round_dt(q) * k) of a pair on one bf16x2 multiply
          // (the product of two bf16 values is exact before its rounding)
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(e);
#pragma unroll
          for (int c = 0; c < VW / 2; ++c) {
            const float2 f = __bfloat1622float2(__hmul2(
                __floats2bfloat162_rn(q[d0 + 2 * c], q[d0 + 2 * c + 1]), k2[c]));
            s += f.x;
            if constexpr (kTwoSums)
              s2 += f.y;
            else
              s += f.y;
          }
        } else {
#pragma unroll
          for (int c = 0; c < VW; ++c)
            s += round_dt<T>(round_dt<T>(q[d0 + c]) * to_f<T>(e[c]));
        }
      }
    } else {
      for (int d = 0; d < Dh; ++d)
        s += round_dt<T>(round_dt<T>(q[d]) * to_f<T>(kp[d]));
    }
    sc[p] = (s + s2) * scale;
  }
  float s_new = -INFINITY;
  if (kn != nullptr) {
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32) acc += q[d] * kn[d];
    s_new = warp_sum(acc) * scale;
  }
  float m = -INFINITY;
  for (int p = lane; p < n; p += 32) m = fmaxf(m, sc[p]);
  m = fmaxf(warp_max(m), s_new);
  float sum = 0.f;
  for (int p = lane; p < n; p += 32) {
    const float e = expf(sc[p] - m);
    sc[p] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  const float e_new = kn != nullptr ? expf(s_new - m) : 0.f;
  if (kn != nullptr) sum += e_new;
  __syncwarp();
  if (vec) {
    const int LP = Dh / VW;  // lanes per value row
    const int g = lane / LP, c0 = (lane % LP) * VW;
    float acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.f;
#pragma unroll kPU
    for (int p = g; p < n; p += 32 / LP) {
      const float w = round_dt<T>(normalized ? sc[p] / sum : sc[p]);
      const uint4 u =
          *reinterpret_cast<const uint4*>(v + (size_t)p * Dh + c0);
      const T* e = reinterpret_cast<const T*>(&u);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const __nv_bfloat162 w2 = __float2bfloat162_rn(w);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(e);
#pragma unroll
        for (int i = 0; i < VW / 2; ++i) {
          const float2 f = __bfloat1622float2(__hmul2(w2, v2[i]));
          acc[2 * i] += f.x;
          acc[2 * i + 1] += f.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] += round_dt<T>(w * to_f<T>(e[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < VW; ++i)
      for (int off = LP; off < 32; off <<= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        if (vn != nullptr) acc[i] += e_new * vn[c0 + i];
        o[c0 + i] = round_dt<T>(normalized ? acc[i] : acc[i] / sum);
      }
    }
  } else {
    float acc[kMaxNI];
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int p = 0; p < n; ++p) {
      const float w = round_dt<T>(normalized ? sc[p] / sum : sc[p]);
      const T* vp = v + (size_t)p * Dh;
#pragma unroll
      for (int i = 0; i < kMaxNI; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) acc[i] += round_dt<T>(w * to_f<T>(vp[d]));
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh && vn != nullptr) acc[i] += e_new * vn[d];
      if (d < Dh) o[d] = round_dt<T>(normalized ? acc[i] : acc[i] / sum);
    }
  }
  __syncwarp();
}

// L decoder layers and the final LayerNorm for the block's rows at
// position t: xs (the embedded input) -> hs. The chunk kernels write each
// layer's new k/v row into the cache and attend to it there; decode_step
// (kStep) writes it to k_new / v_new and attends to it in f32.
template <typename T, int R, bool kStep>
__device__ void trunk(const Args<T>& a, const Smem& sm, float* smem, int b0,
                      int t) {
  float* xs = smem + sm.xs;
  float* hs = smem + sm.hs;
  float* big = smem + sm.big;
  float* os = smem + sm.os;
  float* sc = smem + sm.sc;
  float* red = smem + sm.red;
  const Trunk<T>& w = a.w;
  const int warp = threadIdx.x >> 5;
  const int d = a.d, H = a.H, Dh = a.Dh, HD = H * Dh, BH = a.B * H;
  const int dff = a.dff, trow = a.Tmax > a.Mq ? a.Tmax : a.Mq;
  constexpr int VW = 16 / sizeof(T);
  // 16-byte k/v loads need 16-byte aligned rows in every cache, and the
  // P.V butterfly a power-of-two number of vectors per row
  const int LP = Dh / VW;
  const int vec = Dh % VW == 0 && (LP & (LP - 1)) == 0 &&
                  reinterpret_cast<uintptr_t>(a.kc) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.vc) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.ck) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.cv) % 16 == 0;

  for (int i = 0; i < a.L; ++i) {
    // ---- cached causal self-attention --------------------------------
    block_ln<T, R>(xs, hs, d, w.ln1s + i * d, w.ln1b + i * d);
    const float* bqkv = w.s_bqkv + (size_t)i * 3 * HD;
    matmul<T, R>(w.s_wqkv + (size_t)i * d * 3 * HD, d, 3 * HD, hs, d, red,
              [&](int r, int n, float v) {
                big[r * 3 * HD + n] = v + bqkv[n];
              });
    if (a.qk_norm) {
      head_ln<R>(big, 3 * HD, H, Dh, w.s_qns + i * Dh, w.s_qnb + i * Dh);
      head_ln<R>(big + HD, 3 * HD, H, Dh, w.s_kns + i * Dh,
                 w.s_knb + i * Dh);
    }
    for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD;
      if (b0 + r >= a.B) continue;
      const float* row = big + r * 3 * HD;
      const size_t head = (size_t)i * BH + (size_t)(b0 + r) * H + c / Dh;
      if constexpr (kStep) {
        a.k_new[head * Dh + c % Dh] = from_f<T>(row[HD + c]);
        a.v_new[head * Dh + c % Dh] = from_f<T>(row[2 * HD + c]);
      } else {
        const size_t off = (head * a.Tmax + t) * Dh + c % Dh;
        a.kc[off] = from_f<T>(row[HD + c]);
        a.vc[off] = from_f<T>(row[2 * HD + c]);
      }
    }
    __syncthreads();
    for (int pair = warp; pair < R * H; pair += kWarps) {
      const int r = pair / H, h = pair % H;
      float* o = os + r * HD + h * Dh;
      if (b0 + r >= a.B) {
        for (int n = threadIdx.x & 31; n < Dh; n += 32) o[n] = 0.f;
        continue;
      }
      const size_t base = ((size_t)i * BH + (size_t)(b0 + r) * H + h) *
                          a.Tmax * Dh;
      const float* row = big + r * 3 * HD + h * Dh;
      if constexpr (kStep)
        attend<T>(row, a.kc + base, a.vc + base, t, Dh, a.scale, false, vec,
                  sc + pair * trow, o, row + HD, row + 2 * HD);
      else
        attend<T>(row, a.kc + base, a.vc + base, t + 1, Dh, a.scale, false,
                  vec, sc + pair * trow, o);
    }
    __syncthreads();
    const float* bo = w.s_bo + (size_t)i * d;
    matmul<T, R>(w.s_wo + (size_t)i * HD * d, HD, d, os, HD, red,
              [&](int r, int n, float v) {
                xs[r * d + n] =
                    round_dt<T>(xs[r * d + n] + round_dt<T>(v + bo[n]));
              });
    // ---- cross-attention to the precomputed bottleneck K/V ------------
    block_ln<T, R>(xs, hs, d, w.ln2s + i * d, w.ln2b + i * d);
    const float* bq = w.c_bq + (size_t)i * HD;
    matmul<T, R>(w.c_wq + (size_t)i * d * HD, d, HD, hs, d, red,
              [&](int r, int n, float v) { big[r * HD + n] = v + bq[n]; });
    if (a.qk_norm)
      head_ln<R>(big, HD, H, Dh, w.c_qns + i * Dh, w.c_qnb + i * Dh);
    for (int pair = warp; pair < R * H; pair += kWarps) {
      const int r = pair / H, h = pair % H;
      float* o = os + r * HD + h * Dh;
      if (b0 + r >= a.B) {
        for (int n = threadIdx.x & 31; n < Dh; n += 32) o[n] = 0.f;
        continue;
      }
      const size_t base = ((size_t)i * BH + (size_t)(b0 + r) * H + h) *
                          a.Mq * Dh;
      attend<T>(big + r * HD + h * Dh, a.ck + base, a.cv + base, a.Mq,
                    Dh, a.scale, true, vec, sc + pair * trow, o);
    }
    __syncthreads();
    const float* cbo = w.c_bo + (size_t)i * d;
    matmul<T, R>(w.c_wo + (size_t)i * HD * d, HD, d, os, HD, red,
              [&](int r, int n, float v) {
                xs[r * d + n] =
                    round_dt<T>(xs[r * d + n] + round_dt<T>(v + cbo[n]));
              });
    // ---- FFN -------------------------------------------------------------
    block_ln<T, R>(xs, hs, d, w.ln3s + i * d, w.ln3b + i * d);
    const float* b1 = w.b1 + (size_t)i * dff;
    matmul<T, R>(w.w1 + (size_t)i * d * dff, d, dff, hs, d, red,
              [&](int r, int n, float v) {
                big[r * dff + n] = round_dt<T>(fmaxf(v + b1[n], 0.f));
              });
    const float* b2 = w.b2 + (size_t)i * d;
    matmul<T, R>(w.w2 + (size_t)i * dff * d, dff, d, big, dff, red,
              [&](int r, int n, float v) {
                xs[r * d + n] =
                    round_dt<T>(xs[r * d + n] + round_dt<T>(v + b2[n]));
              });
  }
  block_ln<T, R>(xs, hs, d, w.lnfs, w.lnfb);
}

// better (value, index) of two argmax candidates: larger value, then the
// smaller index (the first-index rule of jnp.argmax)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// per-thread argmax of dt(h.W) + bias over the thread's column groups
template <typename T, int R, int CW>
__device__ void head_argmax(const T* __restrict__ W, int Kd, int N,
                            const float* __restrict__ src,
                            const float* __restrict__ bias,
                            float (&bv)[R], int (&bi)[R]) {
  for (int g = threadIdx.x; g < N / CW; g += kThreads) {
    const int n0 = g * CW;
    float acc[R][CW];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
#pragma unroll kUnroll
    for (int k = 0; k < Kd; ++k) {
      float wv[CW];
      load_w<T, CW>(W + (size_t)k * N + n0, wv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = src[r * Kd + k];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const float bc = bias[n0 + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = round_dt<T>(acc[r][c]) + bc;
        if (v > bv[r]) {  // columns rise within a thread: first index wins
          bv[r] = v;
          bi[r] = n0 + c;
        }
      }
    }
  }
}

template <typename T, int R, bool kCont>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const Args<T> a, const Smem sm) {
  extern __shared__ float smem[];
  __shared__ int prev_s[R], fin_s[R];
  __shared__ float row_s[R][5];
  __shared__ float best_v[kWarps][R];
  __shared__ int best_i[kWarps][R];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * R;
  const int d = a.d;
  float* xs = smem + sm.xs;
  float* hs = smem + sm.hs;
  float* big = smem + sm.big;
  float* red = smem + sm.red;

  if (tid < R) {
    const int b = b0 + tid;
    const bool ok = b < a.B;
    fin_s[tid] = ok ? a.fin_in[b] : 1;
    if constexpr (kCont) {
      for (int c = 0; c < 5; ++c)
        row_s[tid][c] = ok ? a.prev_row[b * 5 + c] : 0.f;
    } else {
      prev_s[tid] = ok ? a.prev_tok[b] : a.pad_id;
    }
  }
  __syncthreads();

  for (int j = 0; j < a.K; ++j) {
    const int t = a.t0 + j;
    // ---- embed: dt(dt(e * sqrt_d) + dt(pos)) ------------------------------
    for (int idx = tid; idx < R * d; idx += kThreads) {
      const int r = idx / d, n = idx % d;
      float e;
      if constexpr (kCont) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 5; ++c)
          acc = fmaf(round_dt<T>(row_s[r][c]), to_f<T>(a.in_w[c * d + n]), acc);
        e = round_dt<T>(round_dt<T>(acc) + round_dt<T>(a.in_b[n]));
      } else {
        e = to_f<T>(a.in_w[(size_t)prev_s[r] * d + n]);
      }
      xs[idx] = round_dt<T>(round_dt<T>(e * a.sqrt_d) +
                            to_f<T>(a.pos[(size_t)j * d + n]));
    }
    __syncthreads();
    trunk<T, R, false>(a, sm, smem, b0, t);

    if constexpr (kCont) {
      // ---- MDN head: greedy component mean and pen state -------------------
      const int P = a.N, M = a.M;
      matmul<T, R>(a.head_w, d, P, hs, d, red, [&](int r, int n, float v) {
        big[r * P + n] = round_dt<T>(round_dt<T>(v) + round_dt<T>(a.head_b[n]));
      });
      if (tid < R) {
        const int r = tid, b = b0 + r;
        const float* raw = big + r * P;
        int comp = 0;
        for (int m = 1; m < M; ++m)
          if (raw[m] > raw[comp]) comp = m;
        int pen = 0;
        for (int c = 1; c < 3; ++c)
          if (raw[6 * M + c] > raw[6 * M + pen]) pen = c;
        float mx = raw[M + comp], my = raw[2 * M + comp];
        const bool fin = fin_s[r] != 0;
        if (fin) {
          pen = a.pen_end;
          mx = 0.f;
          my = 0.f;
        }
        if (pen == a.pen_end) fin_s[r] = 1;
        row_s[r][0] = mx;
        row_s[r][1] = my;
        for (int c = 0; c < 3; ++c) row_s[r][2 + c] = pen == c ? 1.f : 0.f;
        if (b < a.B) {
          const size_t o = (size_t)b * a.K + j;
          a.xy[2 * o] = mx;
          a.xy[2 * o + 1] = my;
          a.pen[o] = pen;
          a.valid[o] = fin ? 0 : 1;
        }
      }
    } else {
      // ---- vocab head fused with the first-index argmax --------------------
      float bv[R];
      int bi[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bv[r] = -INFINITY;
        bi[r] = INT_MAX;
      }
      constexpr int VW = 16 / sizeof(T);
      const uintptr_t hw = reinterpret_cast<uintptr_t>(a.head_w);
      if (hw % 16 == 0 && a.N % VW == 0)
        head_argmax<T, R, VW>(a.head_w, d, a.N, hs, a.head_b, bv, bi);
      else if (hw % 8 == 0 && a.N % 4 == 0)
        head_argmax<T, R, 4>(a.head_w, d, a.N, hs, a.head_b, bv, bi);
      else
        head_argmax<T, R, 1>(a.head_w, d, a.N, hs, a.head_b, bv, bi);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = bv[r];
        int i = bi[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = __shfl_xor_sync(0xffffffffu, i, o);
          if (better(ov, oi, v, i)) {
            v = ov;
            i = oi;
          }
        }
        if (lane == 0) {
          best_v[warp][r] = v;
          best_i[warp][r] = i;
        }
      }
      __syncthreads();
      if (tid < R) {
        const int r = tid, b = b0 + r;
        float v = best_v[0][r];
        int nxt = best_i[0][r];
        for (int wi = 1; wi < kWarps; ++wi)
          if (better(best_v[wi][r], best_i[wi][r], v, nxt)) {
            v = best_v[wi][r];
            nxt = best_i[wi][r];
          }
        // a row of NaN logits picks no lane of the table (at most a
        // padded lane): PAD, so the next embedding stays inside the table
        if (fin_s[r] || nxt >= a.vocab) nxt = a.pad_id;
        if (nxt == a.eos_id) fin_s[r] = 1;
        prev_s[r] = nxt;
        if (b < a.B) a.ids[(size_t)b * a.K + j] = nxt;
      }
    }
    __syncthreads();
  }
  if (tid < R && b0 + tid < a.B) a.fin_out[b0 + tid] = fin_s[tid];
}

// decode_step: the embedded rows in, one trunk pass, the final LayerNorm's
// output out
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const Args<T> a, const Smem sm) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * R, d = a.d;
  float* xs = smem + sm.xs;
  const float* hs = smem + sm.hs;
  for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
    const int b = b0 + idx / d;
    xs[idx] = b < a.B ? to_f<T>(a.x_in[(size_t)b * d + idx % d]) : 0.f;
  }
  __syncthreads();
  trunk<T, R, true>(a, sm, smem, b0, a.t0);
  for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
    const int b = b0 + idx / d;
    if (b < a.B) a.h_out[(size_t)b * d + idx % d] = from_f<T>(hs[idx]);
  }
}

// ===========================================================================
// bfloat16: the batch as the products' rows, one thread block cluster a row
// group (see the header)
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int kMaxGroup = 64;                      // rows a cluster holds
constexpr int kProducts = 6;                       // a layer's products
constexpr int kSmemLimit = 232448;
constexpr int kMaxCluster = 16;
constexpr int kMaxTiles = 16;                      // 16-column tiles a slice
// the cluster kernel's kinds: a token chunk, an MDN chunk, a decoder step
constexpr int kKindToken = 0, kKindMdn = 1, kKindStep = 2;

// ops/decode_chunk.py::cluster_plan, in PLAN_KEYS order: blocks a cluster,
// rows a group, ring stages, ring slot (bf16 elements: the weight slice,
// then from pofs its f32 parameters: the bias slice in bmax floats, the
// LayerNorm scale and bias before the product, the qk-norm scales and
// biases), head columns a chunk, padded head width, row strides of hs and
// act (elements), (row, head) pairs a block; then byte offsets into the
// dynamic shared memory and its total. Then the work split the kernel
// reads: each product's slice width (its TMA box), the column boundaries
// of the C blocks' slices of each product and of the head (block c:
// [cols[k][c], cols[k][c + 1])), and the ways the inner dimension of a
// G x 16 n slice is split (split[0]: inner dimension d, split[1]: dff).
// The (row, head) pair p of a group belongs to block p % C, slot p / C
// (ops/decode_chunk.py::pair_owner).
struct CPlan {
  int C, G, NS, slot, pofs, bmax, hcols, Np, ld_hs, ld_act, slots;
  int o_xs, o_hs, o_act, o_own, o_state, o_sc, o_ring, o_lbuf, o_cand,
      o_mdn, total;
  int ldw[kProducts];
  int cols[kProducts + 1][kMaxCluster + 1];
  int split[2][kMaxTiles + 1];
};
constexpr int kPlanInts = 22 + kProducts + (kProducts + 1) * (kMaxCluster + 1) +
                          2 * (kMaxTiles + 1);
static_assert(sizeof(CPlan) == kPlanInts * sizeof(int),
              "CPlan must be the plan's int array");

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// every thread of every block of the cluster: what each wrote before (its
// pushes into other blocks' shared memory, its cache rows) is seen by all
// after; split into arrive and wait, so a thread can work in between
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

// the address of local shared memory p in block `rank` of the cluster
__device__ __forceinline__ uint32_t cl_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cl_v2(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};" ::"r"(a), "r"(x),
               "r"(y)
               : "memory");
}

__device__ __forceinline__ void st_cl_v4(uint32_t a, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// one product slice of the weight stream: the (Kd, N) row-major weight's
// columns [c0, c0 + nc) for this block, landing as ldw-wide rows
struct Prod {
  int kind;               // its tensor map: the six products', then the head
  int row0;               // its first row in the map (the layer's)
  int ldw;                // the map's box columns: the slice's row stride
  int Kd, N, c0, nc;
  int S;                  // ways its inner dimension is split (the plan's)
  const float* bias;      // the N-wide bias (its [c0, c0 + nc) is copied)
  const float* ln;        // the LayerNorm before the product: scale, bias
  const float* lnb;
  const float* qk[4];     // qk-norm scales and biases, or null
};

// product `pos` of a step for block `rank`: a layer's six (QKV, out-proj,
// cross q, cross out-proj, FFN in, FFN out), then the head's chunks of the
// block's columns [h0, h0 + hn)
// the block's slice of each product kind, read from the plan once a
// launch: first column, columns, box width, inner-dimension ways
struct Slices {
  int c0[kProducts], nc[kProducts], ldw[kProducts], S[kProducts];
};

__device__ __forceinline__ Prod product(const Args<bf16>& a, const CPlan& p,
                                        const Slices& sl, int pos, int h0,
                                        int hn) {
  const int d = a.d, Dh = a.Dh, HD = a.H * Dh, dff = a.dff;
  const Trunk<bf16>& t = a.w;
  Prod q;
  q.kind = pos < kProducts * a.L ? pos - pos / kProducts * kProducts
                                 : kProducts;
  q.ln = q.lnb = nullptr;
  for (int k = 0; k < 4; ++k) q.qk[k] = nullptr;
  if (pos < kProducts * a.L) {
    const int i = pos / kProducts;
    switch (pos - i * kProducts) {
      case 0:
        q.Kd = d, q.N = 3 * HD;
        q.bias = t.s_bqkv + (size_t)i * 3 * HD;
        q.ln = t.ln1s + i * d, q.lnb = t.ln1b + i * d;
        q.qk[0] = t.s_qns + i * Dh, q.qk[1] = t.s_qnb + i * Dh;
        q.qk[2] = t.s_kns + i * Dh, q.qk[3] = t.s_knb + i * Dh;
        break;
      case 1:
        q.Kd = HD, q.N = d;
        q.bias = t.s_bo + (size_t)i * d;
        break;
      case 2:
        q.Kd = d, q.N = HD;
        q.bias = t.c_bq + (size_t)i * HD;
        q.ln = t.ln2s + i * d, q.lnb = t.ln2b + i * d;
        q.qk[0] = t.c_qns + i * Dh, q.qk[1] = t.c_qnb + i * Dh;
        break;
      case 3:
        q.Kd = HD, q.N = d;
        q.bias = t.c_bo + (size_t)i * d;
        break;
      case 4:
        q.Kd = d, q.N = dff;
        q.bias = t.b1 + (size_t)i * dff;
        q.ln = t.ln3s + i * d, q.lnb = t.ln3b + i * d;
        break;
      default:
        q.Kd = dff, q.N = d;
        q.bias = t.b2 + (size_t)i * d;
        break;
    }
    const int k = pos - i * kProducts;
    q.row0 = i * q.Kd;
    q.ldw = sl.ldw[k];
    q.c0 = sl.c0[k];
    q.nc = sl.nc[k];
    q.S = sl.S[k];
  } else {
    const int ch = pos - kProducts * a.L;
    q.row0 = 0;
    q.ldw = p.hcols;
    q.Kd = d;
    q.N = p.Np;
    q.c0 = h0 + ch * p.hcols;
    q.nc = min(p.hcols, h0 + hn - q.c0);
    q.S = p.split[0][q.nc / 16];
    q.bias = a.head_b;
    if (ch == 0) q.ln = t.lnfs, q.lnb = t.lnfb;
  }
  return q;
}

// epi(r, n, v0, v1) for the output columns n, n + 1 (n even) of row r of
// A[G x Kd] . Ws[Kd x nc], both bf16 in shared memory (row strides lda and
// ldw), on mma.sync m16n8k16 with f32 accumulators. A warp takes a
// 16 x 16 tile; when the slice has fewer tiles than warps, the inner
// dimension is split S ways too (the plan's split), and the partial
// tiles meet in `red` (added in split order).
template <typename Epi>
__device__ void cl_product(const bf16* A, int lda, const bf16* Ws, int ldw,
                           int Kd, int nc, int S, int G, float* red,
                           Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = G / 16, nt = nc / 16, items = mt * nt, ks = Kd / 16;
  for (int idx = warp; idx < items * S; idx += kWarps) {
    const int it = idx % items, s = idx / items;
    const int m = it / nt, n = it - m * nt;
    // two chains of k-steps (even, odd), added at the end
    float acc[2][4], acc2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc2[j][e] = 0.f;
    const bf16* ap = A + (m * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda +
                     8 * (lane >> 4);
    const bf16* bp = Ws + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldw + n * 16 +
                     8 * (lane >> 4);
    const int k1 = (s + 1) * (ks / S);
    for (int kk = s * (ks / S); kk < k1; kk += 2) {
      uint32_t af[4], bfr[4], af2[4], bfr2[4];
      const bool two = kk + 1 < k1;
      ldsm_x4(af, smem_u32(ap + kk * 16));
      ldsm_x4_t(bfr, smem_u32(bp + kk * 16 * ldw));
      if (two) {
        ldsm_x4(af2, smem_u32(ap + (kk + 1) * 16));
        ldsm_x4_t(bfr2, smem_u32(bp + (kk + 1) * 16 * ldw));
      }
      mma16816(acc[0], af, bfr[0], bfr[1]);
      mma16816(acc[1], af, bfr[2], bfr[3]);
      if (two) {
        mma16816(acc2[0], af2, bfr2[0], bfr2[1]);
        mma16816(acc2[1], af2, bfr2[2], bfr2[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += acc2[j][e];
    // C fragment: rows lane / 4 (+ 8), columns 2 (lane % 4) (+ 1) of each
    // 8-column half j
    const int rr = lane >> 2, cc = 2 * (lane & 3);
    if (S == 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(m * 16 + rr + 8 * h, n * 16 + 8 * j + cc, acc[j][2 * h],
              acc[j][2 * h + 1]);
    } else {
      float* rp = red + (s * items + it) * 256;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rp[(rr + 8 * h) * 16 + 8 * j + cc] = acc[j][2 * h];
          rp[(rr + 8 * h) * 16 + 8 * j + cc + 1] = acc[j][2 * h + 1];
        }
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < items * 128; e += kThreads) {
      const int it = e / 128, w = e % 128, r = w / 8, c = 2 * (w % 8);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int s = 0; s < kWarps; ++s)
        if (s < S) {
          const float2 f = *reinterpret_cast<const float2*>(
              red + (s * items + it) * 256 + r * 16 + c);
          v0 += f.x;
          v1 += f.y;
        }
      const int m = it / nt;
      epi(m * 16 + r, (it - m * nt) * 16 + c, v0, v1);
    }
  }
}

// hs[r] = dt(LN(xs[r])) for the G rows (xs row stride d, hs ld, d a
// multiple of 8), a half-warp a row reading 16-byte vectors; no barrier
__device__ void group_ln(const bf16* __restrict__ xs, bf16* __restrict__ hs,
                         int ld, int G, int d, const float* __restrict__ s,
                         const float* __restrict__ b) {
  const int half = threadIdx.x >> 4, l16 = threadIdx.x & 15, nv = d / 8;
  for (int r = half; r < G; r += kThreads / 16) {
    const bf16* x = xs + (size_t)r * d;
    float sum = 0.f, ss = 0.f;
    for (int v = l16; v < nv; v += 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(x + 8 * v);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float f = to_f<bf16>(e[c]);
        sum += f;
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // within the half-warp
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = sum / d;
    const float rstd = 1.f / sqrtf(fmaxf(ss / d - mu * mu, 0.f) + kLnEps);
    for (int v = l16; v < nv; v += 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(x + 8 * v);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 8 * v + 2 * c;
        op[c] = pack_bf16((to_f<bf16>(e[2 * c]) - mu) * rstd * s[n] + b[n],
                          (to_f<bf16>(e[2 * c + 1]) - mu) * rstd * s[n + 1] +
                              b[n + 1]);
      }
      *reinterpret_cast<uint4*>(hs + (size_t)r * ld + 8 * v) = o;
    }
  }
}

// the block's G x nc bf16 tile staged at stg (row stride nc) to every block
// of the cluster, at column c0 of dst (row stride ld), a 16-byte store a
// thread at a time; begins with a block barrier (the tile complete)
__device__ void broadcast(const bf16* stg, int G, int nc, bf16* dst, int ld,
                          int c0, int C) {
  __syncthreads();
  const int groups = nc / 8, per = G * groups;
  for (int idx = threadIdx.x; idx < per * C; idx += kThreads) {
    const int c = idx / per, e = idx - c * per, r = e / groups;
    const int g = e - r * groups;
    st_cl_v4(cl_addr(dst + (size_t)r * ld + c0 + 8 * g, c),
             *reinterpret_cast<const uint4*>(stg + r * nc + 8 * g));
  }
}

// per-head LayerNorm (qk-norm) of one head's n f32 values in place, by one
// warp
__device__ __forceinline__ void warp_ln(float* x, int n,
                                        const float* __restrict__ s,
                                        const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f, ss = 0.f;
  for (int k = lane; k < n; k += 32) {
    sum += x[k];
    ss += x[k] * x[k];
  }
  sum = warp_sum(sum);
  ss = warp_sum(ss);
  const float mu = sum / n;
  const float rstd = 1.f / sqrtf(fmaxf(ss / n - mu * mu, 0.f) + kLnEps);
  for (int k = lane; k < n; k += 32) x[k] = (x[k] - mu) * rstd * s[k] + b[k];
  __syncwarp();
}

// the tensor maps of the six products' stacked weights ((L K, N), boxes of
// a block's widest column slice by min(K, 256) rows) and of the padded head
// ((d, Np), boxes of hcols columns)
struct WMaps {
  CUtensorMap m[kProducts + 1];
};

template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
decode_cluster_kernel(const Args<bf16> a, const __grid_constant__ CPlan p,
                      const __grid_constant__ WMaps maps) {
  constexpr bool kCont = kKind == kKindMdn;
  constexpr bool kIsStep = kKind == kKindStep;
  extern __shared__ __align__(128) unsigned char csm[];
  __shared__ __align__(8) uint64_t wbar[3];  // a ring slot's arrival
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.C, G = p.G, rank = cluster_rank();
  const int b0 = (int)(blockIdx.x / C) * G;
  const int d = a.d, H = a.H, Dh = a.Dh, HD = H * Dh, BH = a.B * H;
  const int trow = a.Tmax > a.Mq ? a.Tmax : a.Mq;
  bf16* xs = reinterpret_cast<bf16*>(csm + p.o_xs);     // [G][d]
  bf16* hs = reinterpret_cast<bf16*>(csm + p.o_hs);     // [G][ld_hs]
  bf16* act = reinterpret_cast<bf16*>(csm + p.o_act);   // [G][ld_act]
  float* own = reinterpret_cast<float*>(csm + p.o_own); // [slots][3][Dh]
  // a broadcast product's staged G x nc tile: own is free in those phases
  bf16* stg = reinterpret_cast<bf16*>(own);
  int* prev_s = reinterpret_cast<int*>(csm + p.o_state);
  int* fin_s = prev_s + G;
  float* row_s = reinterpret_cast<float*>(fin_s + G);   // [G][5], then the
                                                        // head's best [2][G]
  float* red = reinterpret_cast<float*>(csm + p.o_sc);  // split partials
  float* sc = red + warp * (trow + Dh);  // this warp's score row,
  float* ow = sc + trow;                 // then its attention output
  bf16* ring = reinterpret_cast<bf16*>(csm + p.o_ring);
  float* lbuf = reinterpret_cast<float*>(csm + p.o_lbuf);  // token head
  uint2* cand = reinterpret_cast<uint2*>(csm + p.o_cand);  // [C][G]
  bf16* mdn = reinterpret_cast<bf16*>(csm + p.o_mdn);      // [G][Np]
  const int h0 = p.cols[kProducts][rank];
  const int hn = p.cols[kProducts][rank + 1] - h0;
  // the head's chunks of the block's columns (the step has no head)
  const int nh = kIsStep ? 0 : (hn + p.hcols - 1) / p.hcols;

  // the weight stream: every product slice of every step in order, with
  // its parameters, NS - 1 slices in flight ahead of the one in use; warp 0
  // issues each slice as TMA boxes and its parameters as bulk copies, all
  // completing on the slot's mbarrier
  const int per_step = kProducts * a.L + nh;
  const int total = a.K * per_step;
  __shared__ Slices sl;
  if (tid < kProducts) {
    sl.c0[tid] = p.cols[tid][rank];
    sl.nc[tid] = p.cols[tid][rank + 1] - sl.c0[tid];
    sl.ldw[tid] = p.ldw[tid];
    sl.S[tid] = p.split[tid == kProducts - 1 ? 1 : 0][sl.nc[tid] / 16];
  }
  // the ring's positions: the next slice to issue and to use, each as
  // (index, position in its step, slot, the slot's fill parity)
  int issued = 0, ipos = 0, islot = 0;
  int used = 0, upos = 0, uslot = 0;
  uint32_t uparity = 0;
  auto issue = [&]() {
    if (warp == 0 && issued < total) {
      // lane 0 arms the slot's mbarrier; then one copy a lane: the TMA
      // boxes (lanes 0, 1), the bias slice (2), the LayerNorm's scale and
      // bias (3, 4), the qk-norm's (5-8)
      const Prod w = product(a, p, sl, ipos, h0, hn);
      const int s = islot;
      bf16* dst = ring + (size_t)s * p.slot;
      const uint32_t bar = smem_u32(&wbar[s]);
      const int rows = w.Kd < 256 ? w.Kd : 256;
      float* prm = reinterpret_cast<float*>(dst + p.pofs);
      if (lane == 0) {
        uint32_t bytes = (uint32_t)w.Kd * w.ldw * 2 + w.nc * 4;
        if (w.ln != nullptr) bytes += 2 * d * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (w.qk[k] != nullptr) bytes += Dh * 4;
        mbar_arrive_expect_tx(bar, bytes);
      }
      __syncwarp();
      if (lane < 2) {
        const int r0 = lane * rows;
        if (r0 < w.Kd)
          tma_load_2d(smem_u32(dst + r0 * w.ldw), &maps.m[w.kind], bar, w.c0,
                      w.row0 + r0);
      } else if (lane == 2) {
        if (w.nc > 0) bulk_load(smem_u32(prm), w.bias + w.c0, w.nc * 4, bar);
      } else if (lane < 5) {
        if (w.ln != nullptr)
          bulk_load(smem_u32(prm + p.bmax + (lane - 3) * d),
                    lane == 3 ? w.ln : w.lnb, d * 4, bar);
      } else if (lane < 9) {
        // constant indices keep the descriptor in registers
        const int k = lane - 5;
        const float* src = k == 0   ? w.qk[0]
                           : k == 1 ? w.qk[1]
                           : k == 2 ? w.qk[2]
                                    : w.qk[3];
        if (src != nullptr)
          bulk_load(smem_u32(prm + p.bmax + 2 * d + k * Dh), src, Dh * 4,
                    bar);
      }
    }
    ++issued;
    if (++ipos == per_step) ipos = 0;
    if (++islot == p.NS) islot = 0;
  };
  // the slices owed to the ring: NS - 1 ahead of the one in use, the next
  // into the slot the last product read
  auto top_up = [&]() {
    while (issued < used + p.NS - 1) issue();
  };
  // the next product's slice and parameters, landed
  auto next = [&](Prod& w, const float*& prm) -> const bf16* {
    mbar_wait(smem_u32(&wbar[uslot]), uparity);
    w = product(a, p, sl, upos, h0, hn);
    const bf16* slot = ring + (size_t)uslot * p.slot;
    prm = reinterpret_cast<const float*>(slot + p.pofs);
    const bool head = upos >= kProducts * a.L;
    ++used;
    if (++upos == per_step) upos = 0;
    if (++uslot == p.NS) {
      uslot = 0;
      uparity ^= 1u;
    }
    // a head chunk, which no cluster barrier follows, refills the slot
    // the chunk before it read once every warp is past that chunk (after
    // a trunk product the cluster barrier orders the refill)
    if (head) {
      __syncthreads();
      top_up();
    }
    return slot;
  };
  // the end of a phase: a cluster barrier, warp 0 refilling the ring while
  // it waits for the other blocks
  auto phase_end = [&]() {
    cluster_arrive();
    top_up();
    cluster_wait();
  };
  // start the L2 fetch of layer i's k/v rows [0, t) and cross K/V of the
  // block's pairs, ahead of their attention
  auto prefetch_pairs = [&](int i, int t) {
    if (lane != 0) return;
    for (int s = warp; s < p.slots; s += kWarps) {
      const int pr = s * C + rank, b = b0 + pr / H;
      if (pr >= G * H || b >= a.B) break;
      const size_t head = (size_t)i * BH + (size_t)b * H + pr % H;
      if (t > 0) {
        prefetch_l2(a.kc + head * a.Tmax * Dh, t * Dh * 2);
        prefetch_l2(a.vc + head * a.Tmax * Dh, t * Dh * 2);
      }
      prefetch_l2(a.ck + head * a.Mq * Dh, a.Mq * Dh * 2);
      prefetch_l2(a.cv + head * a.Mq * Dh, a.Mq * Dh * 2);
    }
  };
  // the block's (row, head) pairs, a warp each: attention (self: after
  // qk-norm and the new k/v row into the cache, or for the step into
  // k_new / v_new, attended from its f32 values; cross (std::true_type):
  // against the bottleneck K/V) on 16-byte k/v rows, the output row pushed
  // to every block's act; qkn the qk-norm scales and biases
  auto attend_pairs = [&](int i, int t, auto cross, const float* qkn) {
    for (int s = warp; s < p.slots; s += kWarps) {
      const int pr = s * C + rank;
      if (pr >= G * H) break;
      const int r = pr / H, h = pr - r * H, b = b0 + r;
      float* q = own + s * 3 * Dh;
      if (b < a.B) {
        const size_t head = (size_t)i * BH + (size_t)b * H + h;
        if constexpr (decltype(cross)::value) {
          if (a.qk_norm) warp_ln(q, Dh, qkn, qkn + Dh);
          const size_t base = head * a.Mq * Dh;
          attend<bf16, 1, 4, true, true>(q, a.ck + base, a.cv + base, a.Mq,
                                         Dh, a.scale, true, 1, sc, ow);
        } else {
          if (a.qk_norm) {
            warp_ln(q, Dh, qkn, qkn + Dh);
            warp_ln(q + Dh, Dh, qkn + 2 * Dh, qkn + 3 * Dh);
          }
          const size_t base = head * a.Tmax * Dh;
          if constexpr (kIsStep) {
            // the new row out, rounded; the caches' rows [0, t) and the
            // new position's f32 key and value (still in q + Dh, q + 2 Dh)
            for (int n = lane; n < Dh; n += 32) {
              a.k_new[head * Dh + n] = from_f<bf16>(q[Dh + n]);
              a.v_new[head * Dh + n] = from_f<bf16>(q[2 * Dh + n]);
            }
            attend<bf16, 2, 8, true, true>(q, a.kc + base, a.vc + base, t,
                                           Dh, a.scale, false, 1, sc, ow,
                                           q + Dh, q + 2 * Dh);
          } else {
            for (int n = lane; n < Dh; n += 32) {
              a.kc[base + (size_t)t * Dh + n] = from_f<bf16>(q[Dh + n]);
              a.vc[base + (size_t)t * Dh + n] = from_f<bf16>(q[2 * Dh + n]);
            }
            __syncwarp();
            attend<bf16, 2, 8, true, true>(q, a.kc + base, a.vc + base,
                                           t + 1, Dh, a.scale, false, 1, sc,
                                           ow);
          }
        }
      } else {
        for (int n = lane; n < Dh; n += 32) ow[n] = 0.f;
        __syncwarp();
      }
      const int groups = Dh / 8;
      for (int e = lane; e < groups * C; e += 32) {
        const int c = e / groups, g = e - c * groups;
        uint4 v;
        uint32_t* vp = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          vp[k] = pack_bf16(ow[8 * g + 2 * k], ow[8 * g + 2 * k + 1]);
        st_cl_v4(cl_addr(act + r * p.ld_act + h * Dh + 8 * g, c), v);
      }
      __syncwarp();
    }
  };
  // the LayerNorm before a product (its scale and bias in the product's
  // parameters), finished before the product reads it
  auto norm = [&](const float* prm) {
    group_ln(xs, hs, p.ld_hs, G, d, prm + p.bmax, prm + p.bmax + d);
    __syncthreads();
  };
  // a product whose output joins the residual stream: xs = dt(xs +
  // dt(v + bias)), the block's columns pushed to every block
  auto residual = [&]() {
    Prod w;
    const float* prm;
    const bf16* ws = next(w, prm);
    cl_product(act, p.ld_act, ws, w.ldw, w.Kd, w.nc, w.S, G, red,
               [&](int r, int n, float v0, float v1) {
                 const bf16* x = xs + r * d + w.c0 + n;
                 *reinterpret_cast<uint32_t*>(stg + r * w.nc + n) = pack_bf16(
                     to_f<bf16>(x[0]) + round_dt<bf16>(v0 + prm[n]),
                     to_f<bf16>(x[1]) + round_dt<bf16>(v1 + prm[n + 1]));
               });
    broadcast(stg, G, w.nc, xs, d, w.c0, C);
  };
  // LayerNorm, then q (qkv = false: the cross q) values to the block owning
  // their pair, f32, after the bias; returns the qk-norm parameters
  auto to_owners = [&](bool qkv) -> const float* {
    Prod w;
    const float* prm;
    const bf16* ws = next(w, prm);
    norm(prm);
    cl_product(hs, p.ld_hs, ws, w.ldw, w.Kd, w.nc, w.S, G, red,
               [&](int r, int n, float v0, float v1) {
                 const int c = w.c0 + n, which = qkv ? c / HD : 0;
                 const int hd = c - which * HD, h = hd / Dh, pr = r * H + h;
                 float* dst = own + (pr / C) * 3 * Dh + which * Dh + hd - h * Dh;
                 st_cl_v2(cl_addr(dst, pr % C), __float_as_uint(v0 + prm[n]),
                          __float_as_uint(v1 + prm[n + 1]));
               });
    return prm + p.bmax + 2 * d;
  };

  if constexpr (!kIsStep) {
    for (int r = tid; r < G; r += kThreads) {
      const int b = b0 + r;
      const bool ok = b < a.B;
      fin_s[r] = ok ? a.fin_in[b] : 1;
      if constexpr (kCont) {
        for (int c = 0; c < 5; ++c)
          row_s[r * 5 + c] = ok ? a.prev_row[b * 5 + c] : 0.f;
      } else {
        prev_s[r] = ok ? a.prev_tok[b] : a.pad_id;
      }
    }
  }
  if (tid == 0) {
    for (int s = 0; s < p.NS; ++s) mbar_init(smem_u32(&wbar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  top_up();
  cluster_sync_all();  // every block runs before the first push

  for (int j = 0; j < a.K; ++j) {
    const int t = a.t0 + j;
    // ---- embed: dt(dt(e * sqrt_d) + dt(pos)), every block all G rows; the
    // step reads its embedded rows (zeros past B) -------------------------
    const int nv = d / 8;
    for (int idx = tid; idx < G * nv; idx += kThreads) {
      const int r = idx / nv, n = 8 * (idx - r * nv);
      if constexpr (kIsStep) {
        *reinterpret_cast<uint4*>(xs + r * d + n) =
            b0 + r < a.B ? *reinterpret_cast<const uint4*>(
                               a.x_in + (size_t)(b0 + r) * d + n)
                         : make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      float e[8];
      if constexpr (kCont) {
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = 0.f;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const float x = round_dt<bf16>(row_s[r * 5 + c]);
          const uint4 u = *reinterpret_cast<const uint4*>(a.in_w + c * d + n);
          const bf16* wv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k) e[k] = fmaf(x, to_f<bf16>(wv[k]), e[k]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = round_dt<bf16>(round_dt<bf16>(e[k]) +
                                round_dt<bf16>(a.in_b[n + k]));
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(
            a.in_w + (size_t)prev_s[r] * d + n);
        const bf16* ev = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = to_f<bf16>(ev[k]);
      }
      const uint4 pu =
          *reinterpret_cast<const uint4*>(a.pos + (size_t)j * d + n);
      const bf16* pv = reinterpret_cast<const bf16*>(&pu);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        op[k] = pack_bf16(
            round_dt<bf16>(e[2 * k] * a.sqrt_d) + to_f<bf16>(pv[2 * k]),
            round_dt<bf16>(e[2 * k + 1] * a.sqrt_d) + to_f<bf16>(pv[2 * k + 1]));
      *reinterpret_cast<uint4*>(xs + r * d + n) = o;
    }
    __syncthreads();  // the rows complete before the LayerNorm reads them
    for (int i = 0; i < a.L; ++i) {
      prefetch_pairs(i, t);
      // ---- cached causal self-attention --------------------------------
      const float* qkn = to_owners(true);
      phase_end();
      attend_pairs(i, t, std::false_type{}, qkn);
      phase_end();
      residual();
      phase_end();
      // ---- cross-attention to the precomputed bottleneck K/V ------------
      qkn = to_owners(false);
      phase_end();
      attend_pairs(i, t, std::true_type{}, qkn);
      phase_end();
      residual();
      phase_end();
      // ---- FFN ---------------------------------------------------------
      {
        Prod w;
        const float* prm;
        const bf16* ws = next(w, prm);
        norm(prm);
        cl_product(hs, p.ld_hs, ws, w.ldw, w.Kd, w.nc, w.S, G, red,
                   [&](int r, int n, float v0, float v1) {
                     *reinterpret_cast<uint32_t*>(stg + r * w.nc + n) =
                         pack_bf16(fmaxf(v0 + prm[n], 0.f),
                                   fmaxf(v1 + prm[n + 1], 0.f));
                   });
        broadcast(stg, G, w.nc, act, p.ld_act, w.c0, C);
      }
      phase_end();
      residual();
      phase_end();
    }

    // ---- the head: the final LayerNorm with its first chunk -------------
    if constexpr (kIsStep) {
      // the step: the final LayerNorm (its parameters read in place), each
      // block writing the rows r = rank (mod C) of the group
      group_ln(xs, hs, p.ld_hs, G, d, a.w.lnfs, a.w.lnfb);
      __syncthreads();
      for (int idx = tid; idx < G * nv; idx += kThreads) {
        const int r = idx / nv, n = 8 * (idx - r * nv);
        if (r % C == rank && b0 + r < a.B)
          *reinterpret_cast<uint4*>(a.h_out + (size_t)(b0 + r) * d + n) =
              *reinterpret_cast<const uint4*>(hs + (size_t)r * p.ld_hs + n);
      }
    } else if constexpr (kCont) {
      // MDN: the 6M+3 values to every block, then the pick
      for (int ch = 0; ch < nh; ++ch) {
        Prod w;
        const float* prm;
        const bf16* ws = next(w, prm);
        if (ch == 0) norm(prm);
        cl_product(hs, p.ld_hs, ws, w.ldw, w.Kd, w.nc, w.S, G, red,
                   [&](int r, int n, float v0, float v1) {
                     *reinterpret_cast<uint32_t*>(stg + r * w.nc + n) =
                         pack_bf16(round_dt<bf16>(v0) + round_dt<bf16>(prm[n]),
                                   round_dt<bf16>(v1) +
                                       round_dt<bf16>(prm[n + 1]));
                   });
        broadcast(stg, G, w.nc, mdn, p.Np, w.c0, C);
      }
      phase_end();
      for (int r = tid; r < G; r += kThreads) {
        const bf16* raw = mdn + r * p.Np;
        const int M = a.M;
        int comp = 0;
        for (int m = 1; m < M; ++m)
          if (to_f<bf16>(raw[m]) > to_f<bf16>(raw[comp])) comp = m;
        int pn = 0;
        for (int c = 1; c < 3; ++c)
          if (to_f<bf16>(raw[6 * M + c]) > to_f<bf16>(raw[6 * M + pn])) pn = c;
        float mx = to_f<bf16>(raw[M + comp]), my = to_f<bf16>(raw[2 * M + comp]);
        const bool fin = fin_s[r] != 0;
        if (fin) {
          pn = a.pen_end;
          mx = 0.f;
          my = 0.f;
        }
        if (pn == a.pen_end) fin_s[r] = 1;
        row_s[r * 5 + 0] = mx;
        row_s[r * 5 + 1] = my;
        for (int c = 0; c < 3; ++c) row_s[r * 5 + 2 + c] = pn == c ? 1.f : 0.f;
        const int b = b0 + r;
        if (rank == 0 && b < a.B) {
          const size_t o = (size_t)b * a.K + j;
          a.xy[2 * o] = mx;
          a.xy[2 * o + 1] = my;
          a.pen[o] = pn;
          a.valid[o] = fin ? 0 : 1;
        }
      }
    } else {
      // token: each block's slice argmax (a warp a row, the running best
      // in shared memory), then the cluster's
      float* best_v = row_s + 5 * G;
      int* best_i = reinterpret_cast<int*>(best_v + G);
      for (int r = tid; r < G; r += kThreads) {
        best_v[r] = -INFINITY;
        best_i[r] = INT_MAX;
      }
      for (int ch = 0; ch < nh; ++ch) {
        Prod w;
        const float* prm;
        const bf16* ws = next(w, prm);
        if (ch == 0) norm(prm);
        cl_product(hs, p.ld_hs, ws, w.ldw, w.Kd, w.nc, w.S, G, red,
                   [&](int r, int n, float v0, float v1) {
                     float* l = lbuf + r * p.hcols + n;
                     l[0] = round_dt<bf16>(v0) + prm[n];
                     l[1] = round_dt<bf16>(v1) + prm[n + 1];
                   });
        __syncthreads();
        for (int r = warp; r < G; r += kWarps) {
          float v = -INFINITY;
          int ix = INT_MAX;
          for (int n = lane; n < w.nc; n += 32) {
            const float lv = lbuf[r * p.hcols + n];
            if (better(lv, w.c0 + n, v, ix)) {
              v = lv;
              ix = w.c0 + n;
            }
          }
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, o);
            const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
            if (better(ov, oi, v, ix)) {
              v = ov;
              ix = oi;
            }
          }
          if (lane == 0 && better(v, ix, best_v[r], best_i[r])) {
            best_v[r] = v;
            best_i[r] = ix;
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < G * C; idx += kThreads) {
        const int r = idx % G, c = idx / G;
        st_cl_v2(cl_addr(cand + rank * G + r, c), __float_as_uint(best_v[r]),
                 (uint32_t)best_i[r]);
      }
      phase_end();
      for (int r = tid; r < G; r += kThreads) {
        float v = -INFINITY;
        int nxt = INT_MAX;
        for (int c = 0; c < C; ++c) {
          const uint2 u = cand[c * G + r];
          if (better(__uint_as_float(u.x), (int)u.y, v, nxt)) {
            v = __uint_as_float(u.x);
            nxt = (int)u.y;
          }
        }
        // a row of NaN logits picks no lane of the table (at most a
        // padded lane): PAD, so the next embedding stays inside the table
        if (fin_s[r] || nxt >= a.vocab) nxt = a.pad_id;
        if (nxt == a.eos_id) fin_s[r] = 1;
        prev_s[r] = nxt;
        const int b = b0 + r;
        if (rank == 0 && b < a.B) a.ids[(size_t)b * a.K + j] = nxt;
      }
    }
    __syncthreads();
  }
  if (rank == 0 && !kIsStep)
    for (int r = tid; r < G; r += kThreads)
      if (b0 + r < a.B) a.fin_out[b0 + r] = fin_s[r];
  cluster_sync_all();
}

// the cluster kernel of a kind (kKindToken, kKindMdn, kKindStep)
using ClusterKernel = void (*)(const Args<bf16>, CPlan, WMaps);

ClusterKernel cluster_kernel(int kind) {
  return kind == kKindToken ? decode_cluster_kernel<kKindToken>
         : kind == kKindMdn ? decode_cluster_kernel<kKindMdn>
                            : decode_cluster_kernel<kKindStep>;
}

cudaError_t cluster_attrs(ClusterKernel kernel, int C, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int C,
                                  int clusters, int smem,
                                  cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the launcher refuses a plan the kernel cannot run (kind: kKindToken,
// kKindMdn or kKindStep; the step's plan has no head: hcols = Np = 0)
int launch_cluster(const Args<bf16>& a, const int* plan, int kind,
                   cudaStream_t stream) {
  CPlan p;
  memcpy(&p, plan, sizeof(p));
  const bool step = kind == kKindStep;
  const int offs[] = {p.o_xs, p.o_hs, p.o_act, p.o_own, p.o_state,
                      p.o_sc, p.o_ring, p.o_lbuf, p.o_cand, p.o_mdn};
  bool ok = kind >= kKindToken && kind <= kKindStep && p.C >= 1 &&
            p.C <= 16 && p.G >= 16 && p.G % 16 == 0 &&
            p.G <= kMaxGroup && (p.NS == 2 || p.NS == 3) && p.total > 0 &&
            p.total <= kSmemLimit &&
            (step ? p.hcols == 0 && p.Np == 0 && a.K == 1
                  : p.hcols >= 16 && p.hcols % 16 == 0 && p.Np % 16 == 0) &&
            p.slots * p.C >= p.G * a.H &&
            p.pofs % 64 == 0 && p.slot % 64 == 0 && p.bmax % 16 == 0 &&
            p.o_ring % 128 == 0 &&
            a.d % 16 == 0 && a.dff % 16 == 0 && a.Dh % 8 == 0 &&
            ((a.Dh / 8) & (a.Dh / 8 - 1)) == 0;
  const void* kv[4] = {a.kc, a.vc, a.ck, a.cv};  // 16-byte k/v rows
  for (const void* q : kv) ok = ok && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (int o : offs) ok = ok && o >= 0 && o % 16 == 0 && o < p.total;
  const int HD = a.H * a.Dh;
  const bf16* W[kProducts] = {a.w.s_wqkv, a.w.s_wo, a.w.c_wq,
                              a.w.c_wo,   a.w.w1,   a.w.w2};
  const int Kd[kProducts] = {a.d, HD, a.d, HD, a.d, a.dff};
  const int N[kProducts] = {3 * HD, a.d, HD, a.d, a.dff, a.d};
  // the slices: whole tiles, in order, covering each width once, each
  // inside its box, its bias slice and its split's partial tiles inside
  // their shared memory
  ok = ok && p.C <= kMaxCluster && p.Np == a.N;
  for (int k = 0; k <= kProducts && ok; ++k) {
    const int* c = p.cols[k];
    const int box = k == kProducts ? p.hcols : p.ldw[k];
    ok = c[0] == 0 && c[p.C] == (k == kProducts ? p.Np : N[k]);
    for (int r = 0; r < p.C && ok; ++r)
      ok = c[r] % 16 == 0 && c[r + 1] >= c[r] &&
           (k == kProducts || c[r + 1] - c[r] <= box);
  }
  for (int j = 0; j < 2 && ok; ++j)
    for (int n = 0; n <= kMaxTiles && 16 * n <= p.bmax && ok; ++n) {
      const int S = p.split[j][n], items = p.G / 16 * n;
      const int ks = (j ? a.dff : a.d) / 16;
      ok = (S == 1 || S == 2 || S == 4 || S == 8) && ks % S == 0 &&
           (S == 1 || (S * items <= kWarps &&
                       p.o_sc + S * items * 1024 <= p.o_ring));
    }
  WMaps maps;
  memset(&maps, 0, sizeof(maps));
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  for (int k = 0; k < (step ? kProducts : kProducts + 1) && ok; ++k) {
    const bool head = k == kProducts;
    const int K = head ? a.d : Kd[k], n = head ? p.Np : N[k];
    const int box = head ? p.hcols : p.ldw[k];
    const int rows = K < 256 ? K : 256;
    ok = K % rows == 0 && K / rows <= 2 && box % 16 == 0 && box <= 256 &&
         box <= p.bmax && (size_t)K * box <= (size_t)p.pofs &&
         tmap_2d(&maps.m[k], encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                 head ? a.head_w : W[k], head ? K : a.L * K, n, box, rows,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const ClusterKernel kernel = cluster_kernel(kind);
  const cudaError_t err = cluster_attrs(kernel, p.C, p.total);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, p.C, (a.B + p.G - 1) / p.G, p.total, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, p, maps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `iters` cluster barriers and nothing else, in `clusters` clusters of C
// blocks: the serial cost of one barrier
__global__ void __launch_bounds__(kThreads)
cluster_barrier_kernel(int iters) {
  for (int k = 0; k < iters; ++k) cluster_sync_all();
}

// kind: 0 token chunk, 1 MDN chunk, 2 decode step
template <typename T, int R, int kKind>
int launch(const Args<T>& a, cudaStream_t stream) {
  const Smem sm(R, a.d, a.dff, a.H, a.Dh, a.Tmax, a.Mq, kKind == 1 ? a.N : 0);
  const size_t bytes = sizeof(float) * (size_t)sm.total;
  auto kernel = kKind == 2 ? decode_step_kernel<T, R>
                           : decode_chunk_kernel<T, R, kKind == 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + R - 1) / R);
  kernel<<<grid, kThreads, bytes, stream>>>(a, sm);
  return (int)cudaGetLastError();
}

// One row per block while the rows fit the card's SMs (each block streams
// the weights once per step, so more blocks buy bandwidth); two per block
// beyond that, which halves the weight traffic of a larger batch.
template <typename T, int kKind>
int launch_rows(const Args<T>& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (a.B <= sms) return launch<T, 1, kKind>(a, stream);
  return launch<T, 2, kKind>(a, stream);
}

// the weights, caches, dims and scalars every kernel of this file reads;
// the rest null. Returns 0, or an error for a geometry it cannot run.
template <typename T>
int common_args(Args<T>& a, const void* const* weights, void* kc, void* vc,
                const void* ck, const void* cv, const int* dims,
                const float* fdims) {
  memset(&a, 0, sizeof(a));
  memcpy(&a.w, weights, sizeof(a.w));
  a.kc = static_cast<T*>(kc);
  a.vc = static_cast<T*>(vc);
  a.ck = static_cast<const T*>(ck);
  a.cv = static_cast<const T*>(cv);
  a.B = dims[kB];
  a.L = dims[kL];
  a.H = dims[kH];
  a.Dh = dims[kDh];
  a.d = dims[kD];
  a.dff = dims[kDff];
  a.Tmax = dims[kTmax];
  a.Mq = dims[kMq];
  a.K = dims[kK];
  a.t0 = dims[kT0];
  a.N = dims[kN];
  a.qk_norm = dims[kQkNorm];
  a.pad_id = dims[kPad];
  a.eos_id = dims[kEos];
  a.M = dims[kM];
  a.pen_end = dims[kPenEnd];
  a.vocab = dims[kVocab];
  a.scale = fdims[0];
  a.sqrt_d = fdims[1];
  if (a.t0 < 0 || a.K < 1 || a.t0 + a.K > a.Tmax || a.Dh * a.H != a.d ||
      a.Dh > 32 * kMaxNI)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int run(int cont, const void* const* weights, void* kc, void* vc,
        const void* ck, const void* cv, const void* pos, const void* head_w,
        const void* head_b, const void* in_w, const void* in_b,
        const void* prev_tok, const void* prev_row, const void* fin_in,
        void* ids, void* xy, void* pen, void* valid, void* fin_out,
        const int* dims, const float* fdims, const int* plan,
        cudaStream_t stream) {
  Args<T> a;
  const int err = common_args(a, weights, kc, vc, ck, cv, dims, fdims);
  if (err) return err;
  a.pos = static_cast<const T*>(pos);
  a.head_w = static_cast<const T*>(head_w);
  a.head_b = static_cast<const float*>(head_b);
  a.in_w = static_cast<const T*>(in_w);
  a.in_b = static_cast<const float*>(in_b);
  a.prev_tok = static_cast<const int*>(prev_tok);
  a.prev_row = static_cast<const float*>(prev_row);
  a.fin_in = static_cast<const int*>(fin_in);
  a.ids = static_cast<int*>(ids);
  a.xy = static_cast<float*>(xy);
  a.pen = static_cast<int*>(pen);
  a.valid = static_cast<int*>(valid);
  a.fin_out = static_cast<int*>(fin_out);
  if (plan != nullptr) {
    if constexpr (std::is_same<T, bf16>::value)
      return launch_cluster(a, plan, cont ? kKindMdn : kKindToken, stream);
    return (int)cudaErrorInvalidValue;
  }
  return cont ? launch_rows<T, 1>(a, stream) : launch_rows<T, 0>(a, stream);
}

template <typename T>
int run_step(const void* const* weights, const void* kc, const void* vc,
             const void* ck, const void* cv, const void* x, void* h,
             void* k_new, void* v_new, const int* dims, const float* fdims,
             const int* plan, cudaStream_t stream) {
  Args<T> a;
  const int err = common_args(a, weights, const_cast<void*>(kc),
                              const_cast<void*>(vc), ck, cv, dims, fdims);
  if (err) return err;
  a.x_in = static_cast<const T*>(x);
  a.h_out = static_cast<T*>(h);
  a.k_new = static_cast<T*>(k_new);
  a.v_new = static_cast<T*>(v_new);
  if (plan != nullptr) {
    if constexpr (std::is_same<T, bf16>::value) {
      // 16-byte rows of the input and the output
      if (reinterpret_cast<uintptr_t>(x) % 16 ||
          reinterpret_cast<uintptr_t>(h) % 16)
        return (int)cudaErrorInvalidValue;
      return launch_cluster(a, plan, kKindStep, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  return launch_rows<T, 2>(a, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; cont: 0 = token, 1 = MDN.
// weights: the kNumWeights stacked-weight pointers; dims: kNumDims ints in
// the enum's order; fdims: {attention scale, sqrt(d) in the dtype}; plan:
// null for the per-row kernel, else the kPlanInts ints of
// ops/decode_chunk.py::cluster_plan for the bf16 cluster kernel (head_w
// and head_b then of its Np columns, whole 16-column tiles).
extern "C" int sk_decode_chunk(int dtype, int cont, const void* const* weights,
                               void* kc, void* vc, const void* ck,
                               const void* cv, const void* pos,
                               const void* head_w, const void* head_b,
                               const void* in_w, const void* in_b,
                               const void* prev_tok, const void* prev_row,
                               const void* fin_in, void* ids, void* xy,
                               void* pen, void* valid, void* fin_out,
                               const int* dims, const float* fdims,
                               const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(cont, weights, kc, vc, ck, cv, pos, head_w, head_b,
                      in_w, in_b, prev_tok, prev_row, fin_in, ids, xy, pen,
                      valid, fin_out, dims, fdims, plan, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(cont, weights, kc, vc, ck, cv, pos, head_w,
                              head_b, in_w, in_b, prev_tok, prev_row, fin_in,
                              ids, xy, pen, valid, fin_out, dims, fdims, plan,
                              s);
  return (int)cudaErrorInvalidValue;
}

// the clusters of C blocks, each with smem bytes of shared memory, that
// the card runs at once for the cluster kernel (kind: 0 token chunk, 1 MDN
// chunk, 2 decode step)
extern "C" int sk_decode_cluster_fit(int kind, int C, int smem,
                                     int* clusters) {
  if (kind < kKindToken || kind > kKindStep)
    return (int)cudaErrorInvalidValue;
  const ClusterKernel kernel = cluster_kernel(kind);
  const cudaError_t err = cluster_attrs(kernel, C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, C, 1, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// `iters` back-to-back cluster barriers in each of `clusters` clusters of
// C blocks of the cluster kernel's 256 threads (a measurement probe)
extern "C" int sk_cluster_barrier_probe(int C, int clusters, int iters,
                                        void* stream) {
  if (C > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_barrier_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, C, clusters, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel,
                                             iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// decode_step at position dims[kT0] (dims[kK] = 1): x (B, d) in, h (B, d)
// and the new rows k_new / v_new (L, B*H, Dh) out; the caches are read.
// plan: null for the per-row kernel, else the kPlanInts ints of
// ops/decode_chunk.py::cluster_plan with no head (N = 0) for the bf16
// cluster kernel's step kind.
extern "C" int sk_decode_step(int dtype, const void* const* weights,
                              const void* kc, const void* vc, const void* ck,
                              const void* cv, const void* x, void* h,
                              void* k_new, void* v_new, const int* dims,
                              const float* fdims, const int* plan,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_step<float>(weights, kc, vc, ck, cv, x, h, k_new, v_new, dims,
                           fdims, plan, s);
  if (dtype == 1)
    return run_step<__nv_bfloat16>(weights, kc, vc, ck, cv, x, h, k_new,
                                   v_new, dims, fdims, plan, s);
  return (int)cudaErrorInvalidValue;
}
