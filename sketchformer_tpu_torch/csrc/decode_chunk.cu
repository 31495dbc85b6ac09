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
// Mapping. Rows are independent, while steps and layers are serial (step
// j+1 embeds step j's pick; layer i+1 needs layer i's whole row). So a
// block of 8 warps owns R batch rows (R = 1 while the batch fits the SMs,
// else 2) for all K steps and L layers, with no
// grid-wide synchronisation: activations live in shared memory as f32
// values that are exact in the compute dtype, the caches in device memory
// (the new k/v row of each layer and step is written straight into the
// cache, where the next step reads it back), and the weights are read
// from L2. At the ar_decode width the bf16 weights are about 10.5 MB of
// trunk and 5.1 MB of vocab head, which the 50 MB L2 holds.
//
// What bounds it on the card: latency. Every step of every block reads
// all ~15.6 MB of weights out of L2 to do R multiply-adds per weight, and
// one block of 8 warps per SM hides little of the L2 latency of those
// reads, of the cache reads of the self-attention or of its own barriers
// (PERF.md, PR 2, has the measured breakdown and how R was picked: fewer
// rows per block give more blocks but more L2 traffic per sketch). The
// products therefore load 16-byte weight vectors kUnroll rows ahead, keep
// each thread's R x CW sums in registers, and split the inner dimension
// across threads when a product has few columns, so that every thread has
// loads in flight; the attention reads its k/v rows as 16-byte vectors.
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
// (B, d) input at position t, on the same trunk, returning the final
// LayerNorm's output and each layer's new k/v row (L, B*H, Dh) for the
// caller to scatter; the caches are only read, rows [0, t). Its one
// numerical difference from the chunk trunk is the TPU kernel's: the new
// position enters the self-attention from its f32 values before any
// rounding (s_new = q.kn and e_new * vn in f32, o = (ctx + e_new * vn) /
// denom), where the chunk kernels attend to the rounded row they wrote
// into the cache. Only the step loop of ops/decode_step.py (and the probe
// it ports) drives it: the chunk kernels superseded it on the TPU.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).

#include <limits.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

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
  float scale, sqrt_d;
};

// dims array of the C entry point, in this order
enum {
  kB, kL, kH, kDh, kD, kDff, kTmax, kMq, kK, kT0, kN, kQkNorm,
  kPad, kEos, kM, kPenEnd, kNumDims
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
// the n, in f32 throughout (decode_step's new position).
template <typename T>
__device__ void attend(const float* __restrict__ q, const T* k, const T* v,
                       int n, int Dh, float scale, bool normalized, int vec,
                       float* __restrict__ sc, float* __restrict__ o,
                       const float* __restrict__ kn = nullptr,
                       const float* __restrict__ vn = nullptr) {
  const int lane = threadIdx.x & 31;
  constexpr int VW = 16 / sizeof(T);
  for (int p = lane; p < n; p += 32) {
    const T* kp = k + (size_t)p * Dh;
    float s = 0.f;
    if (vec) {
      for (int d0 = 0; d0 < Dh; d0 += VW) {
        const uint4 u = *reinterpret_cast<const uint4*>(kp + d0);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int c = 0; c < VW; ++c)
          s += round_dt<T>(round_dt<T>(q[d0 + c]) * to_f<T>(e[c]));
      }
    } else {
      for (int d = 0; d < Dh; ++d)
        s += round_dt<T>(round_dt<T>(q[d]) * to_f<T>(kp[d]));
    }
    sc[p] = s * scale;
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
#pragma unroll 4
    for (int p = g; p < n; p += 32 / LP) {
      const float w = round_dt<T>(normalized ? sc[p] / sum : sc[p]);
      const uint4 u =
          *reinterpret_cast<const uint4*>(v + (size_t)p * Dh + c0);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[i] += round_dt<T>(w * to_f<T>(e[i]));
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
        if (fin_s[r]) nxt = a.pad_id;
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
// beyond that, which halves the weight traffic of a larger batch (see
// PERF.md, PR 2, for the measured choice).
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
        const int* dims, const float* fdims, cudaStream_t stream) {
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
  return cont ? launch_rows<T, 1>(a, stream) : launch_rows<T, 0>(a, stream);
}

template <typename T>
int run_step(const void* const* weights, const void* kc, const void* vc,
             const void* ck, const void* cv, const void* x, void* h,
             void* k_new, void* v_new, const int* dims, const float* fdims,
             cudaStream_t stream) {
  Args<T> a;
  const int err = common_args(a, weights, const_cast<void*>(kc),
                              const_cast<void*>(vc), ck, cv, dims, fdims);
  if (err) return err;
  a.x_in = static_cast<const T*>(x);
  a.h_out = static_cast<T*>(h);
  a.k_new = static_cast<T*>(k_new);
  a.v_new = static_cast<T*>(v_new);
  return launch_rows<T, 2>(a, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; cont: 0 = token, 1 = MDN.
// weights: the kNumWeights stacked-weight pointers; dims: kNumDims ints in
// the enum's order; fdims: {attention scale, sqrt(d) in the dtype}.
extern "C" int sk_decode_chunk(int dtype, int cont, const void* const* weights,
                               void* kc, void* vc, const void* ck,
                               const void* cv, const void* pos,
                               const void* head_w, const void* head_b,
                               const void* in_w, const void* in_b,
                               const void* prev_tok, const void* prev_row,
                               const void* fin_in, void* ids, void* xy,
                               void* pen, void* valid, void* fin_out,
                               const int* dims, const float* fdims,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(cont, weights, kc, vc, ck, cv, pos, head_w, head_b,
                      in_w, in_b, prev_tok, prev_row, fin_in, ids, xy, pen,
                      valid, fin_out, dims, fdims, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(cont, weights, kc, vc, ck, cv, pos, head_w,
                              head_b, in_w, in_b, prev_tok, prev_row, fin_in,
                              ids, xy, pen, valid, fin_out, dims, fdims, s);
  return (int)cudaErrorInvalidValue;
}

// decode_step at position dims[kT0] (dims[kK] = 1): x (B, d) in, h (B, d)
// and the new rows k_new / v_new (L, B*H, Dh) out; the caches are read.
extern "C" int sk_decode_step(int dtype, const void* const* weights,
                              const void* kc, const void* vc, const void* ck,
                              const void* cv, const void* x, void* h,
                              void* k_new, void* v_new, const int* dims,
                              const float* fdims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_step<float>(weights, kc, vc, ck, cv, x, h, k_new, v_new, dims,
                           fdims, s);
  if (dtype == 1)
    return run_step<__nv_bfloat16>(weights, kc, vc, ck, cv, x, h, k_new,
                                   v_new, dims, fdims, s);
  return (int)cudaErrorInvalidValue;
}
