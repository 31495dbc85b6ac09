"""Operations and bytes of the work each cell does, from its shapes, and
the H100's peaks.

Counting rules (the rooflines and MFUs read these):

- a product (M, K) x (K, N) is 2 M K N operations; attention is 4 d Tq
  per key a query attends (q k^T and p v), counted only over the keys its
  row's mask lets it attend (the valid keys, and under the causal mask
  those at or before the query);
- a kernel's bytes count each input byte read once and each output byte
  written once, in the dtype the program hands it;
- a decode chunk reads the weights, the head and the cross-attention keys
  and values once, and each step's self-attention cache rows once (PERF.md
  section 6's convention);
- a model's FLOPs are its products and attention; embeddings, LayerNorms,
  softmaxes and losses are left out. Training counts three forward passes
  (forward, and the backward's two products a product), and not the
  recompute of the fused stacks' backward.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
HBM = 3.35e12           # H100 SXM HBM3 bytes/s
BF16, F32 = 2, 4


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16, nbytes / HBM)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def linear_call(M: int, K: int, N: int, residual: bool = False
                ) -> Tuple[float, float]:
    """(operations, bytes) of one bf16 ``linear``: a (M, K) and w (K, N)
    bf16 read, the f32 bias read, the bf16 output written, and a bf16
    residual (M, N) read where it is added in the epilogue."""
    nbytes = (M * K + K * N + M * N) * BF16 + N * F32
    if residual:
        nbytes += M * N * BF16
    return 2.0 * M * K * N, float(nbytes)


def encoder_linear_calls(cfg: dict, M: int
                         ) -> List[Tuple[int, int, int, bool]]:
    """(M, K, N, residual) of every ``linear`` of the inference encoder
    stack over M rows: a layer's QKV, output projection (+ residual), FFN
    in (ReLU) and FFN out (+ residual)."""
    d, dff = cfg["d_model"], cfg["dff"]
    layer = [(M, d, 3 * d, False), (M, d, d, True), (M, d, dff, False),
             (M, dff, d, True)]
    return layer * cfg["num_layers"]


def linear_least_s(calls: Iterable[Tuple[int, int, int, bool]]) -> float:
    return sum(least_s(*linear_call(*c)) for c in calls)


def linear_tn_calls(cfg: dict, B: int, T: int
                    ) -> List[Tuple[int, int, int, int]]:
    """(M, K, N, bytes of an element of dy) of every ``linear_tn`` (dW = x^T
    dy with its bias gradient) of one training step of the fused stacks,
    x bf16, dy bf16 where it is the gradient a layer receives and f32
    elsewhere: per encoder layer the FFN out / in, the output projection and
    the QKV; per decoder layer the FFN out / in, the cross-attention's
    output, query and key-value (over the memory's num_queries rows a
    sketch) projections, the self-attention's output and QKV."""
    d, dff, L = cfg["d_model"], cfg["dff"], cfg["num_layers"]
    M, Mq = B * T, B * cfg["num_queries"]
    enc = [(M, dff, d, BF16), (M, d, dff, F32), (M, d, d, F32),
           (M, d, 3 * d, F32)]
    dec = [(M, dff, d, BF16), (M, d, dff, F32), (M, d, d, F32),
           (M, d, d, F32), (Mq, d, 2 * d, F32), (M, d, d, F32),
           (M, d, 3 * d, F32)]
    return enc * L + dec * L


def linear_tn_call(M: int, K: int, N: int, dy_bytes: int
                   ) -> Tuple[float, float]:
    """(operations, bytes): x (M, K) bf16 and dy (M, N) read, the f32 dW
    (K, N) and db (N) written."""
    return 2.0 * M * K * N, float(M * K * BF16 + M * N * dy_bytes
                                  + (K * N + N) * F32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_pairs(T: int, lengths: Sequence[int], causal: bool) -> float:
    """(query, key) pairs that T queries of each row attend, keys limited
    to the row's ``lengths`` valid ones (and to those at or before the
    query under the causal mask)."""
    ln = np.minimum(np.asarray(lengths, dtype=np.float64), T)
    if not causal:
        return float(T * ln.sum())
    # query t attends min(t + 1, n) keys
    return float((ln * (ln + 1) / 2 + (T - ln) * ln).sum())


def encoder_attention_call(cfg: dict, T: int, lengths: Sequence[int]
                           ) -> Tuple[float, float]:
    """(operations, bytes) of one layer's ``encoder_attention``: the
    (B, T, 3d) bf16 qkv and the (B, T) f32 key bias read, the (B, T, d)
    bf16 output written."""
    d = cfg["d_model"]
    B = len(lengths)
    flops = 4.0 * d * attention_pairs(T, lengths, causal=False)
    nbytes = B * T * (3 * d + d) * BF16 + B * T * F32
    return flops, float(nbytes)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def encoder_flops(cfg: dict, T: int, lengths: Sequence[int]) -> float:
    """The encoder stack and the bottleneck's z over a batch."""
    d, dff, L = cfg["d_model"], cfg["dff"], cfg["num_layers"]
    nq, low = cfg["num_queries"], cfg["lowerdim"]
    B = len(lengths)
    M = B * T
    stack = L * (2.0 * M * (4 * d * d + 2 * d * dff)
                 + 4.0 * d * attention_pairs(T, lengths, causal=False))
    if cfg["use_continuous"]:
        stack += 2.0 * M * 3 * d
    pool = (2.0 * B * nq * d * d              # queries' projection
            + 2.0 * M * 2 * d * d             # keys and values
            + 4.0 * d * nq * float(np.minimum(lengths, T).sum())
            + 2.0 * B * nq * d * d            # output projection
            + 2.0 * B * nq * d * low)         # to z
    return stack + pool


def decoder_flops(cfg: dict, T: int, lengths: Sequence[int]) -> float:
    """The teacher-forced decoder over a batch (self-attention over the
    valid keys at or before each query), the expansion of z and the
    reconstruction head."""
    d, dff, L = cfg["d_model"], cfg["dff"], cfg["num_layers"]
    nq, low = cfg["num_queries"], cfg["lowerdim"]
    B = len(lengths)
    M = B * T
    head = 6 * cfg["num_mixtures"] + 3 if cfg["use_continuous"] \
        else cfg["vocab_size"]
    layer = (2.0 * M * (3 * d * d + d * d + d * d + d * d + 2 * d * dff)
             + 4.0 * d * attention_pairs(T, lengths, causal=True)
             + 2.0 * B * nq * d * 2 * d       # cross keys and values
             + 4.0 * d * M * nq)              # cross attention
    extra = 2.0 * M * 5 * d if cfg["use_continuous"] else 0.0
    return (L * layer + 2.0 * B * low * nq * d + 2.0 * M * d * head
            + extra)


def classifier_flops(cfg: dict, B: int) -> float:
    low = cfg["lowerdim"]
    return 2.0 * B * (low * low + low * cfg["num_classes"])


def train_step_flops(cfg: dict, T: int, enc_lengths: Sequence[int],
                     dec_lengths: Sequence[int]) -> float:
    """Three forward passes of the training step's model."""
    B = len(enc_lengths)
    fwd = (encoder_flops(cfg, T, enc_lengths)
           + decoder_flops(cfg, T, dec_lengths) + classifier_flops(cfg, B))
    return 3.0 * fwd


def decode_step_flops(cfg: dict, B: int, t: int) -> float:
    """One greedy decode step at position t (0-based) of B rows: every
    product of the decoder layers, self-attention over t + 1 cached
    positions, cross-attention over the memory, and the head."""
    d, dff, L = cfg["d_model"], cfg["dff"], cfg["num_layers"]
    nq, V = cfg["num_queries"], cfg["vocab_size"]
    per_row = (L * (2.0 * (3 * d * d + d * d + d * d + d * d + 2 * d * dff)
                    + 4.0 * d * (t + 1) + 4.0 * d * nq)
               + 2.0 * d * V)
    return B * per_row


def decode_request_flops(cfg: dict, T: int, lengths: Sequence[int],
                         steps: int) -> float:
    """A reconstruction: the prompts' encoder and z, the memory and its
    cross keys and values, and ``steps`` greedy steps."""
    d, L, nq, low = cfg["d_model"], cfg["num_layers"], cfg["num_queries"], \
        cfg["lowerdim"]
    B = len(lengths)
    setup = (encoder_flops(cfg, T, lengths) + 2.0 * B * low * nq * d
             + L * 2.0 * B * nq * d * 2 * d)
    return setup + sum(decode_step_flops(cfg, B, t) for t in range(steps))


def decode_chunk_call(cfg: dict, B: int, t0: int, K: int
                      ) -> Tuple[float, float]:
    """(operations, bytes) of one decode chunk of K steps from position t0:
    the operations of its steps; the bf16 layer weights, head, token rows
    and position rows read once, the cross keys and values once, each
    step's cache rows (k and v of positions 0 .. t) once, the new rows
    written, and the ids written."""
    d, dff, L = cfg["d_model"], cfg["dff"], cfg["num_layers"]
    nq, V = cfg["num_queries"], cfg["vocab_size"]
    flops = sum(decode_step_flops(cfg, B, t) for t in range(t0, t0 + K))
    weights = L * ((3 * d * d + 3 * d * d + 2 * d * dff) * BF16
                   + (3 * d + d + d + d + dff + d + 6 * d) * F32)
    head = d * V * BF16 + V * F32
    inputs = B * K * d * BF16 * 2             # token rows, position rows
    cross = L * B * nq * 2 * d * BF16
    cache = sum(L * B * (t + 1) * 2 * d * BF16 for t in range(t0, t0 + K))
    written = L * B * K * 2 * d * BF16 + B * K * 4
    return flops, float(weights + head + inputs + cross + cache + written)
