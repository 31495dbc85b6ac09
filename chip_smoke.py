#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sketchformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch / CUDA / nvcc versions;
2. build: compiles ``sketchformer_tpu_torch/csrc`` with nvcc (sm_90a);
3. kernels: each hand-written kernel, and the whole encoder stack, against
   its plain torch version on the card, in float32 and bfloat16, at the
   ``sbir`` preset's geometry (T=192, d=256, H=8, dff=512, L=8; B=64 and
   512), at head_dim 128, with and without qk-norm, under a key mask with
   padded and fully masked rows (the bf16 stack is held to the float32
   computation of its inputs, as accurate as the plain bf16 path);
   ``layernorm_rows`` at the main paths' rows (12,288 and 49,152 x 256),
   D=128 at an odd M and the geometries its register plan declines (bf16
   D=100, f32 D=512, a misaligned view), each on the route it must take
   (``ROUTES``); then the decode kernels: ``decode_attention`` at Tmax=192
   and B*H 512 / 256 / 128 (H=8/4/2 at B=64, Dh 32/64/128) and 511 on
   the bulk kernel, Dh=24 and a misaligned cache on the per-row kernel,
   each with cache_len 1, 17, 31, 96, 191 and 192, ``decode_chunk``
   at the ``ar_decode`` width (B=64, L=8, d=256, H=8, dff=512, V=10,004,
   K=16) from chunk starts 0, 16 and 176 with some rows already finished,
   qk-norm off and on, and at H=2/Dh=128 and H=4/Dh=64, ``decode_cont_chunk``
   at the ``cont2cont_mdn`` width (20 mixtures), both also at B=512 and at
   the SM count + 5 (a part-empty last row group), the head padded once
   (``pad_head``); every bf16 launch on the cluster kernel, every float32
   launch on the per-row one (``ROUTES``), and two bf16 geometries the
   cluster kernel declines (a head left at its width, position rows 8
   bytes off a 16-byte boundary) on the per-row one too; the cache rows
   below the chunk's start untouched. Both sides of a chunk start from
   the same cache; picks must be equal up to each row's first near tie of
   the plain version (top-two gap below 1e-3 in f32, below one bf16 ulp
   of the row's top value in bf16), and new k/v rows and xy close over
   those steps; then the training kernels at the ``cont2cont_mdn`` width
   (B=64, T=192, d=256, dff=512) with H=8/Dh=32 and qk-norm and at
   H=2/Dh=128 without: ``linear_nt`` and ``linear_tn`` (one encoder
   layer's four backward products, with dropout masks and the ReLU gate;
   ``linear_tn``'s weight and bias gradients with 'bits' and in-kernel
   'prng' masks, and equal across two runs),
   ``linear``'s dropout epilogue, ``attention_fwd`` / ``attention_bwd_q``
   / ``attention_bwd_kv`` (self-attention under a key mask, and
   cross-attention to 4 memory rows; the bf16 forward equal across two
   runs), ``layernorm_bwd`` (dx, dscale, dbias in every residual and
   output dtype at D 256, 128 and a ragged 96, equal across two runs, no
   ``sum_rows`` launch), ``sum_rows`` (f32 and compute-dtype rows at the
   (12,288, 768) pane, the f32 attention backward's qk-norm partial rows
   and a ragged shape, equal across two runs); and
   each whole train stack's forward and backward (L=2, dropout 0.1),
   float32 within a relative L2 error of 1e-3 of the plain version on
   three input draws, the plain path taking the ReLU gates the kernels
   set (the gates that differed are counted, and limited), bf16 within
   2x the plain bf16 path's error against float32; the bf16
   attention backward (K5, both passes on the tensor cores) in every mode
   (self-attention with and without causal, cross-attention to 4 memory
   rows, with and without a key bias and qk-norm, T = 1, 96, 192 and 1024,
   Dh 32, 64 and 128): dq, dk, dv, the row statistics and the qk-norm
   gradients within TOL and equal across two runs, with no ``sum_rows``
   launch; then the fused
   vocab-CE head (K6: ``token_ce_fwd``, ``token_ce_dx``, ``token_ce_dw``)
   at the JAX benchmark's ``train`` shape (bf16, M 49,152, d 256, V 10,004)
   and in f32 at M 4,096: ll, lse, dx, dW and db within TOL, corr equal
   away from near ties, the bf16 kernels against the f32 computation, and
   the bf16 dx, dW and db equal across two runs; the bf16 kernels
   redesigned on wgmma + TMA in every mode, each equal across two runs:
   ``ce_dw`` (dW, db) at M 1 / 127 / 129 / 49,152, dp 64-256 and V 2,003
   and 10,004, with no ``sum_rows`` launch, and ``linear_nt`` with a in
   f32 and bf16, no mask / 'bits' / 'prng', the f32 output, the ReLU gate
   and the bf16 residual, at ragged shapes and at each (N, K) of the
   stacks at a ragged M; ``linear`` at M 1 / 127 / 12,293, each (K, N) of
   the stacks, widths not a multiple of 128 and an unaligned K and N, with
   the ReLU, the residual, 'bits' and 'prng' alone and together ('prng'
   equal to 'bits' fed the same bytes); ``token_ce_fwd`` at M 1 / 127 /
   300, dp 64-256, V 65 and 10,004, with three columns planted to tie
   exactly (corr: the first index);
   and the in-kernel dropout draw (K7): ``emit_dropout_bits`` bit-equal to
   the plain Philox at one ``pretrain_full`` site (256, 192, 256), a post-LN
   FFN site (64, 192, 512) (both on the 16-byte route) and a (3, 7, 10)
   site (the byte route, ``ROUTES``), and at (16, 512, 96, 256) with the
   kept share within 1e-3,
   and each 'prng' train stack equal to the 'bits' stack fed the emitted
   bytes (output and every gradient, torch.equal; f32 and bf16); the
   per-op attention (K8, ``flash_attention``: forward, dq, dk, dv) in every
   mask mode (none, key, key + causal, a per-batch and a shared full pane,
   a legacy key mask) with fully masked rows (the bf16 forward and
   backward equal across two runs), at the post-LN
   ``cont2cont_mdn`` width (B=64, T=192, H=8/Dh=32) and the ``cont_train``
   geometry (B=512, T=96, H=2/Dh=128), f32 and bf16 (bf16 gradients also
   within STACK_BF16_FACTOR x the plain path's error against f32), at
   T=1024, and its decline at T=1040 to the composed math; the whole-step
   decode (K13, ``decode_step``) at the ``ar_decode`` width for t = 0, 17
   and 191, qk-norm off and on, H=8 and H=2, B=64 and 40 (bf16 on the
   cluster kernel's step kind, every launch, held against f32 as the
   stacks; f32 on the per-row kernel), a 32-step f32 step loop whose picks
   equal two ``decode_chunk`` launches' up to each row's first near tie,
   and the 32-step bf16 loop against the plain step loop fed its picks,
   every step away from a near tie of 4 ulps;
4. main paths, each with every launch counter reset just before and read
   just after: the port's ``sbir`` CLI at the full width of the ``sbir``
   preset (seeded random weights) over 16 batches of 64 from the preset's
   synthetic 345-class loader, its batches on the packed stack (every
   attention a ``ragged_attention`` launch on the persistent walk, no
   ``encoder_attention``; the batches' valid share printed); then
   classifier logits on z, the kernel z against the plain-path z on one
   batch, padded and packed
   (``fast_embed`` given the batch's valid rows against
   ``encoder_stack_packed_reference``), and ``ragged_attention`` against
   ``ragged_attention_reference`` on that batch's rows, with and without
   qk-norm. Then the port's
   ``decode`` and ``interpolate`` CLI on ``ar_decode`` (B=64, T=192, through
   ``decode_chunk``), ``decode`` on ``cont2cont_mdn`` (greedy, through
   ``decode_cont_chunk``) and with ``--temperature 0.7`` (composed, through
   ``decode_attention``), their outputs finite and of the right shapes.
   In float32 at the same widths, every greedy decode (token chunk
   kernel, MDN chunk kernel, MDN composed on ``decode_attention``) is
   held to the plain teacher-forced forward of its own output: each
   emitted pick that is not a near tie is the argmax of the model given
   the decoded prefix. Then the port's ``train`` CLI on ``cont2cont_mdn``
   (B=64, buckets 96 and 192, bf16, dropout 0.1) for 30 steps: every
   kernel of the train stacks launches and ``sum_rows`` none, neither
   stack declines its kernels, the loss is finite and falls; and ``eval``
   on its checkpoint, whose loss the composed model matches; then
   ``train`` in float32 (2 layers, 3 steps), whose attention backward
   leaves its qk-norm partial rows to ``sum_rows``; then the port's
   ``prep-data`` on 345 per-class npz files of synthetic sketches in the
   sketch-rnn release's layout (the QuickDraw files are not in the repo;
   8 train shards), and the same for token-mode training: ``train`` on
   ``pretrain_full`` on those shards through its own
   ``distributed_stroke3`` loader, warmup 500, through
   the K6 kernels, the stacks drawing their dropout in-kernel (no dropout
   byte tensor drawn) and the composed sites through the emit kernel;
   then the post-LN model (``--hparams norm_first=False``): ``sbir`` and
   ``decode`` on K8 (engines and stacks declined), ``train`` for 30 steps
   with K8 forward and backward 16 times a step and no stack kernel, and
   ``eval`` against the composed model; and the K13 step loop on
   ``ar_decode`` (192 launches, each on the cluster kernel; every CLI path
   launches it 0 times); then data parallelism: the train CLI's body
   (``cli.train``) on ``pretrain_full`` at its full width on the same
   shards by 2 ranks over gloo on the one card (``parallel/multiprocess.py``;
   kernels built once, by this process, before the ranks start; every rank
   with a timeout): 10 steps and the eval, the final metrics and params
   equal across ranks, one checkpoint and one ``metrics.jsonl``, both
   ranks restoring the checkpoint, every rank's bf16 train kernels
   launched, ``eval --run-dir`` on the run dir giving rank 0's final eval;
   at dropout 0 and warmup 30 the 2-rank losses within 7e-5 relative of
   one process on the concatenated 512-row batches, and the same process
   averaging the ranks' local means (two microbatches) outside it; and
   world size 1 on NCCL bit-equal to a run without a group; then the
   reference-weight importer (``tools/import_reference_weights.py``) on a
   made-up reference of seeded weights at the ``ar_decode`` width (shuffled
   names, 2-D leaves stored transposed): template, mapping, import into a
   run dir, and ``embed`` and ``decode`` on that run dir bit-equal to the
   same CLIs on the seeded npz, the run-dir path launching ``linear``,
   ``layernorm_rows``, ``ragged_attention`` (``embed``) and
   ``encoder_attention`` and ``decode_chunk`` (``decode``). Each CLI run
   prints the routes of its ``layernorm_rows`` and ``decode_attention``
   launches and fails if one was declined;
5. times: ``layernorm_rows`` (bf16, M 12,288 and 49,152), K12 (B*H=512,
   Dh=32, cache_len 96 and 191), K13 (B=64, t=96) and K7's emit (one
   ``pretrain_full`` site, and a whole 'bits' stack's tensor) as the median
   and spread of 60 calls' device time beside their plain versions,
   ``F.layer_norm`` and SDPA on the filled slice, and their bounds, and
   the same kernels' own events in a profiler trace; the emit kernel's
   SASS opcodes and the dispatch floor of its Philox calls;
   ``ragged_attention`` (the persistent walk, and beside it the 64-row
   query blocks' grid) on the ``sbir`` loader's first batch beside its
   plain version, and at the embed cell's batch (B=2048, T=192, lengths
   16-191; ``packed_embed_times``), without and with qk-norm, beside the
   padded ``encoder_attention`` and equal to it on the valid rows; the
   decode chunk kernels per chunk (CUDA events after warm-up; each chunk
   at B=64 beside its plain version and its bound, the self-attention
   cache rows counted once a step and the cross K/V once a chunk, and its
   serial floor: the cluster kernel's barriers a step x K x one barrier's
   measured cost; the kernel alone at B=512); K8 forward and
   backward against SDPA with the same mask (and its backward) at both
   geometries; K13 per step beside ``decode_chunk``'s; each training kernel (one layer's
   calls) against its plain version and one PyTorch call where one
   computes the same function (``linear_tn``, ``linear_nt`` (also at the
   ``train`` shape, M 49,152, beside its bound), ``attention_fwd`` at
   B=64/T=192/H=8 with qk-norm and at B=512/T=96/H=2/Dh=128, and K8's
   forward and backward at both geometries as the median and spread of 60
   calls' device time, the host's launches queued ahead (``linear``, a
   layer's four calls, and K6's forward too, at M 12,288 and 49,152,
   beside four ``addmm`` and the ``addmm`` of the logits); the same for
   ``encoder_attention`` against SDPA and the FMA kernel it replaced (at
   ``sbir``, with qk-norm, and at B=512/T=96/H=2), and for the attention
   backward pair (each pass, the pair, one SDPA backward, the bound, and
   the pair at the other owned-row choice) at ``cont2cont_mdn`` with and
   without qk-norm and at B=512/T=96 with H=8/Dh=32 and H=2/Dh=128;
   ``ce_dx`` and
   ``ce_dw`` from 60 calls' kernel events in a profiler trace, the
   wrapper launching both, also at d 64, 128 and 192; ``linear_nt``'s four
   calls also one by one); ``layernorm_bwd`` (M 12,288 and 49,152)
   and ``sum_rows`` ((12,288, 768) and the partial rows) as device time
   against ``native_layer_norm_backward`` and ``sum``; the optimizer step
   (``global_norm`` + ``NoamAdam.step``, three launches) at ``tok_h8``'s
   parameter list against its plain route and its bound; ``sum_rows``
   launches a ``cont2cont_mdn`` and a token step beside the counts before
   its three in-launch sums; the train stacks' forward + backward; K6;
   each with the card's name and power limit. Every kernel's bound (the least time for
   its bytes and operations at the card's published peaks) is computed
   from the timed calls' shapes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --rule2 ROOT LABEL

times the rule-2 kernels (phase 5's first spreads and events) of the
package under ROOT alone: an unpacked ``git archive`` of a parent commit,
run in turns with this checkout in one chip call, reads parent and change
on one card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from sketchformer_tpu_torch.utils import checks, timing
from sketchformer_tpu_torch.utils.checks import TOL, set_attn_impl
from sketchformer_tpu_torch.utils.timing import (
    SPREAD_CALLS,
    TRACE_KEPT_SHARE,
    bound,
    call_ms,
    device_trace,
    gpu_line,
    nvcc_version,
    spread_ms,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "sketchformer_tpu_torch/csrc/"
# source of each Hopper kernel, and the TPU kernel it replaces (the body of
# fused_encoder_stack, whose attention and qk-norm at H=8 run in
# pallas_packed.group_attn_fwd; at H=8/Dh=32 the JAX decode runs the
# lane-packed chunk kernels). encoder_attention's main path (bf16, Dh=32)
# runs the tensor-core forward of attention_train.cu; its FMA kernel in
# encoder_stack.cu serves f32 and the bf16 widths that one does not take.
# ragged_attention is the same forward over packed valid rows, the embed
# path's attention (the TPU kernel pads every sketch to T)
SOURCES = {"linear": "encoder_stack.cu", "encoder_attention":
           "attention_train.cu", "ragged_attention": "attention_train.cu",
           "layernorm_rows": "encoder_stack.cu",
           "decode_chunk": "decode_chunk.cu",
           "decode_cont_chunk": "decode_chunk.cu",
           "decode_attention": "decode_attention.cu",
           "linear_nt": "encoder_stack.cu", "linear_tn": "encoder_stack.cu",
           "attention_fwd": "attention_train.cu",
           "attention_bwd_q": "attention_train.cu",
           "attention_bwd_kv": "attention_train.cu",
           "layernorm_bwd": "norm_train.cu", "sum_rows": "norm_train.cu",
           "token_ce_fwd": "token_ce.cu", "token_ce_dx": "token_ce.cu",
           "token_ce_dw": "token_ce.cu",
           "emit_dropout_bits": "dropout_prng.cu",
           "flash_attention_fwd": "attention_train.cu",
           "flash_attention_bwd": "attention_train.cu",
           "decode_step": "decode_chunk.cu"}
# the training kernels replace parts of the bodies of the TPU training
# kernels: the backward products and the row LayerNorm backward of
# _layer_bwd_kernel (:102, _ln_bwd32 :80, the cross-cell accumulation
# :214), the decoder's attention (_dec_stack_kernel :87) and the small-head
# attention backward (group_attn_bwd)
REPLACES = {
    "linear": "sketchformer_tpu/ops/pallas_encoder.py:140",
    "encoder_attention": "sketchformer_tpu/ops/pallas_packed.py:169",
    "ragged_attention": "sketchformer_tpu/ops/pallas_packed.py:169",
    "layernorm_rows": "sketchformer_tpu/ops/pallas_encoder.py:63",
    "decode_chunk": "sketchformer_tpu/ops/pallas_decode_packed.py:455",
    "decode_cont_chunk": "sketchformer_tpu/ops/pallas_decode_packed.py:549",
    "decode_attention": "sketchformer_tpu/ops/pallas_decode.py:73",
    "linear_nt": "sketchformer_tpu/ops/pallas_encoder_train.py:102",
    "linear_tn": "sketchformer_tpu/ops/pallas_encoder_train.py:102",
    "attention_fwd": "sketchformer_tpu/ops/pallas_decoder_train.py:87",
    "attention_bwd_q": "sketchformer_tpu/ops/pallas_packed.py:341",
    "attention_bwd_kv": "sketchformer_tpu/ops/pallas_packed.py:341",
    "layernorm_bwd": "sketchformer_tpu/ops/pallas_encoder_train.py:80",
    "sum_rows": "sketchformer_tpu/ops/pallas_encoder_train.py:214",
    "token_ce_fwd": "sketchformer_tpu/ops/pallas_ce.py:60",
    "token_ce_dx": "sketchformer_tpu/ops/pallas_ce.py:84",
    "token_ce_dw": "sketchformer_tpu/ops/pallas_ce.py:84",
    "emit_dropout_bits": "sketchformer_tpu/ops/pallas_dropout.py:95",
    "flash_attention_fwd": "sketchformer_tpu/ops/pallas_attention.py:182",
    "flash_attention_bwd": "sketchformer_tpu/ops/pallas_attention.py:249",
    "decode_step": "sketchformer_tpu/ops/pallas_decode_stack.py:223",
}
# layernorm_rows' checks: (M, D, x's offset in elements from a 16-byte
# boundary, route in f32, in bf16): the main paths' rows (sbir and
# cont2cont_mdn's 64 x 192, train's 512 x 96), D=128 (bf16: half a warp a
# row) at an M that is not a multiple of a warp's rows, and the geometries
# the register plan declines (D=100: no whole 16-byte vectors in bf16; f32
# D=512: past the registers; a misaligned view)
LN_ROWS_CHECKS = ((64 * 192, 256, 0, "ln_rows", "ln_rows"),
                  (512 * 96, 256, 0, "ln_rows", "ln_rows"),
                  (1001, 128, 0, "ln_rows", "ln_rows"),
                  (1000, 100, 0, "ln_rows", "ln_declined"),
                  (16, 512, 0, "ln_declined", "ln_rows"),
                  (300, 256, 1, "ln_declined", "ln_declined"))
# the whole bf16 stack: max |kernel - f32| <= this x max |plain bf16 - f32|
STACK_BF16_FACTOR = 2.0
SBIR = dict(T=192, d=256, H=8, dff=512, L=8)
SKETCHES_PER_EPOCH = 345 * 32   # 1380 validation sketches -> >= 16 batches
MAIN_BATCHES = 16
AR = dict(d=256, H=8, dff=512, L=8, V=10004, T=192, K=16, Mq=4)
MDN_MIXTURES = 20                 # cont2cont_mdn
# K12's checks at Tmax 192: (B*H, Dh, the caches' offset in elements from a
# 16-byte boundary, route): the decode's H=8 / 4 / 2 at B=64 on the bulk
# kernel, a B*H that is not a multiple of its rows a block, and the
# geometries it declines to the per-row kernel (Dh=24: three 16-byte
# vectors in bf16, six in f32; caches 2 or 4 bytes off their boundary)
K12_CHECKS = ((512, 32, 0, "bulk"), (256, 64, 0, "bulk"),
              (128, 128, 0, "bulk"), (511, 32, 0, "bulk"),
              (40, 24, 0, "declined"), (64, 32, 1, "declined"))
# bf16 decode chunks: a pick is compared where the plain version's top two
# values are at least this many bf16 ulps of the top value apart
BF16_TIE_ULPS = 4


def randn_from(gen, dev):
    """randn(*shape, scale, dtype): standard normal draws from ``gen`` on
    ``dev``, scaled, in ``dtype``."""
    import torch

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)
    return randn


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def teacher_forced_check(*args, **kwargs):
    """``checks.teacher_forced_check``, a failed check failing the run."""
    try:
        checks.teacher_forced_check(*args, **kwargs)
    except checks.CheckFailed as e:
        fail(str(e))


# ---------------------------------------------------------------------------
# decode kernels against their plain versions
# ---------------------------------------------------------------------------


def main_path_routes(label):
    """Print the routes of the ``layernorm_rows`` and ``decode_attention``
    launches since the counters' last reset; fail if one took a declined
    route (no main path has a geometry the redesigned kernels decline)."""
    from sketchformer_tpu_torch.ops import decode_attention as da
    from sketchformer_tpu_torch.ops import encoder_stack as es

    ln = {k: es.ROUTES[k] for k in ("ln_rows", "ln_declined")}
    print(f"  routes ({label}): layernorm_rows {json.dumps(ln)}, "
          f"decode_attention {json.dumps(da.ROUTES)}")
    if ln["ln_declined"] or da.ROUTES["declined"]:
        fail(f"{label}: a launch took a declined route")


def chunk_operands(randn, gen, dev, *, B, L, d, H, dff, N, Tmax, Mq, K, t0,
                   dtype, cont):
    """Random operands of one decode chunk: stacked trunk weights, cross
    K/V, caches filled below ``t0``, the input embedding, the head and the
    carried state (a third of the rows already finished)."""
    import torch
    import torch.nn.functional as F

    Dh = d // H
    w = {"s_wqkv": randn(L, d, 3 * d, scale=d ** -0.5, dtype=dtype),
         "s_bqkv": randn(L, 3 * d, scale=0.1),
         "s_wo": randn(L, d, d, scale=d ** -0.5, dtype=dtype),
         "s_bo": randn(L, d, scale=0.1),
         "c_wq": randn(L, d, d, scale=d ** -0.5, dtype=dtype),
         "c_bq": randn(L, d, scale=0.1),
         "c_wo": randn(L, d, d, scale=d ** -0.5, dtype=dtype),
         "c_bo": randn(L, d, scale=0.1),
         "w1": randn(L, d, dff, scale=d ** -0.5, dtype=dtype),
         "b1": randn(L, dff, scale=0.1),
         "w2": randn(L, dff, d, scale=dff ** -0.5, dtype=dtype),
         "b2": randn(L, d, scale=0.1),
         "lnfs": 1.0 + randn(1, d, scale=0.1),
         "lnfb": randn(1, d, scale=0.1)}
    for sc, b, n in (("ln1s", "ln1b", d), ("ln2s", "ln2b", d),
                     ("ln3s", "ln3b", d), ("s_qns", "s_qnb", Dh),
                     ("s_kns", "s_knb", Dh), ("c_qns", "c_qnb", Dh)):
        w[sc], w[b] = 1.0 + randn(L, n, scale=0.1), randn(L, n, scale=0.1)
    kc, vc = (torch.zeros(L, B * H, Tmax, Dh, dtype=dtype, device=dev)
              for _ in range(2))
    kc[:, :, :t0] = randn(L, B * H, t0, Dh, dtype=dtype)
    vc[:, :, :t0] = randn(L, B * H, t0, Dh, dtype=dtype)
    ops = dict(k_cache=kc, v_cache=vc,
               cross_k=randn(L, B * H, Mq, Dh, dtype=dtype),
               cross_v=randn(L, B * H, Mq, Dh, dtype=dtype),
               pos_chunk=randn(K, d, dtype=dtype),
               head_w=randn(d, N, scale=d ** -0.5, dtype=dtype),
               head_b=randn(N, scale=0.1), w=w, t0=t0,
               finished=(torch.arange(B, device=dev) % 3 == 1).int())
    if cont:
        ops.update(in_w=randn(5, d, scale=0.5, dtype=dtype),
                   in_b=randn(d, scale=0.1),
                   prev=torch.cat([randn(B, 2), F.one_hot(
                       torch.arange(B, device=dev) % 3, 3).float()], -1))
    else:
        ops.update(emb=randn(N, d, scale=d ** -0.5, dtype=dtype),
                   prev=torch.randint(4, N, (B,), generator=gen,
                                      device=dev).int())
    return ops


def chunk_args(ops, kc, vc, cont):
    head = (ops["in_w"], ops["in_b"]) if cont else (ops["emb"],)
    return (ops["prev"], ops["finished"], kc, vc, ops["cross_k"],
            ops["cross_v"], *head, ops["pos_chunk"], ops["head_w"],
            ops["head_b"], ops["w"], ops["t0"])


def plain_fed_kernel_picks(kname, ops, got, kv, kw, cont):
    """The plain version one step at a time from the same cache, each step
    fed the kernel's pick (and finished state) of the step before: its own
    picks, xy and margins given the kernel's prefix."""
    import torch
    import torch.nn.functional as F

    from sketchformer_tpu_torch.data.pipeline import PEN_END
    from sketchformer_tpu_torch.data.tokenizer import EOS_ID
    from sketchformer_tpu_torch.ops import decode_chunk as dc

    ref = getattr(dc, f"{kname}_reference")
    prev, fin = ops["prev"], ops["finished"]
    outs, margins = [], []
    for j in range(ops["pos_chunk"].shape[0]):
        step = dict(ops, prev=prev, finished=fin, t0=ops["t0"] + j,
                    pos_chunk=ops["pos_chunk"][j:j + 1])
        *out, m = ref(*chunk_args(step, *kv, cont), **kw,
                      return_margins=True)
        outs.append(out[:-1])
        margins.append(m)
        if cont:
            pen = got[1][:, j]
            prev = torch.cat([got[0][:, j], F.one_hot(pen.long(), 3).float()],
                             -1)
            fin = torch.where(pen == PEN_END, 1, fin)
        else:
            prev = got[0][:, j]
            fin = torch.where(prev == EOS_ID, 1, fin)
    return [torch.cat(parts, 1) for parts in zip(*outs)], torch.cat(margins, 1)


def held_to_plain(name, got, want, margins, checked, kv_got, kv_want, kv_rows,
                  t0, dtype):
    """Picks equal and xy close on the ``checked`` (B, K) row-steps, k/v
    rows close on ``kv_rows``. Returns the max abs k/v error."""
    import torch

    B, K = checked.shape
    compared = int(checked.sum())
    if compared < B * K // 2:
        fail(f"{name}: only {compared} of {B * K} row-steps away from a "
             f"near tie; the comparison would prove little")
    tol = TOL[str(dtype).replace("torch.", "")]
    for g, w in zip(got, want):
        if g.is_floating_point():
            err = (g[checked] - w[checked]).abs().max().item()
            if not err <= tol * max(w[checked].abs().max().item(), 1e-30):
                fail(f"{name}: xy differs by {err:.3e}")
        elif not torch.equal(g[checked], w[checked]):
            bad = (g != w) & checked
            b, j = (int(i) for i in bad.nonzero()[0])
            fail(f"{name}: row {b} step {j} picks {int(g[b, j])}, the plain "
                 f"version {int(w[b, j])} (margin {margins[b, j]:.3g})")
    err = ref_max = 0.0
    for g, w in zip(kv_got, kv_want):
        L, BH, _, Dh = g.shape
        rows = kv_rows[None, :, None, :, None].expand(L, B, BH // B, K, Dh)
        g = g[:, :, t0:t0 + K].reshape(L, B, BH // B, K, Dh)[rows].float()
        w = w[:, :, t0:t0 + K].reshape(L, B, BH // B, K, Dh)[rows].float()
        if not torch.isfinite(g).all():
            fail(f"{name}: kernel k/v rows not finite")
        err = max(err, (g - w).abs().max().item())
        ref_max = max(ref_max, w.abs().max().item())
    rel = err / max(ref_max, 1e-30)
    print(f"check {name}: picks equal on {compared}/{B * K} row-steps; k/v "
          f"rows max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:.0e})")
    if not rel <= tol:
        fail(f"{name}: k/v rows rel err {rel:.3e} above {tol:.0e}")
    return err


def check_decode_kernels(randn, gen, dev, errs):
    """Phase 3 for the decode kernels; records the bf16 error at the main
    paths' shapes in ``errs``.

    float32: both sides run the chunk free from the same state, and each
    row is compared up to the plain version's first near tie (top-two gap
    below 1e-3), its k/v rows one step further (that row embeds the last
    agreed pick). bfloat16: 1-ulp rounding flips from summation order grow
    through the 8 layers (as in the encoder stack) and move a logit by
    more than one ulp, so a free-running comparison stops within a few
    steps. There the plain version is fed the kernel's picks step by step
    and every step is compared away from a near tie of BF16_TIE_ULPS ulps.
    """
    import torch

    from sketchformer_tpu_torch.ops import decode_attention as da
    from sketchformer_tpu_torch.ops import decode_chunk as dc

    d, L, dff, V, T, K, Mq = (AR[k] for k in ("d", "L", "dff", "V", "T",
                                              "K", "Mq"))
    steps = torch.arange(K, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        main_rec = dtype == torch.bfloat16
        for BH, Dh, off, route in K12_CHECKS:
            q = randn(BH, 1, Dh, dtype=dtype)
            k, v = (randn(BH * T * Dh + off, dtype=dtype)[off:].view(
                BH, T, Dh) for _ in range(2))
            for n in (1, 17, 31, 96, 191, T):
                before = dict(da.ROUTES)
                got = da.decode_attention(q, k, v, n)
                torch.cuda.synchronize()
                if da.ROUTES != {**before, route: before[route] + 1}:
                    fail(f"decode_attention B*H={BH} Dh={Dh} offset {off}: "
                         f"routes {da.ROUTES} (before {before}), not {route}")
                want = da.decode_attention_reference(q, k, v, n)
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                tol = TOL[tag]
                print(f"check decode_attention {tag} B*H={BH} Dh={Dh} "
                      f"Tmax={T} cache offset {off} cache_len={n} (route "
                      f"{route}): max_abs_err {err:.3e} rel {rel:.3e} (tol "
                      f"{tol:.0e})")
                if not torch.isfinite(got).all() or not rel <= tol:
                    fail(f"decode_attention: rel err {rel:.3e}")
                if main_rec and (BH, Dh, off) == (512, 32, 0):
                    errs["decode_attention"] = max(errs["decode_attention"],
                                                   err)
        # f32 (the per-row kernel): B=64 runs one row per block, a batch
        # above the SM count two (the last block half empty). bf16 (the
        # cluster kernel): B=64 is four 16-row groups, B=512 the largest
        # groups, the SM count + 5 leaves the last group part-empty. The
        # head is padded once (pad_head), as the decode engine does; the
        # last two cases are bf16 geometries the cluster kernel declines
        # (a head left at its width, position rows 8 bytes off a 16-byte
        # boundary), on the per-row kernel, drawn from their own stream
        big = torch.cuda.get_device_properties(dev).multi_processor_count + 5
        cases = [(False, 8, qk, t0, 64, None) for qk in (False, True)
                 for t0 in (0, 16, T - K)]
        cases += [(False, 2, True, 16, 64, None),
                  (False, 8, False, 16, big, None),
                  (True, 8, True, 0, 64, None), (True, 8, True, 176, 64, None),
                  (True, 2, False, 16, 64, None),
                  (True, 8, True, 16, big, None),
                  (False, 4, False, 0, 64, None), (True, 4, True, 16, 64, None),
                  (False, 8, False, 96, 512, None),
                  (True, 8, True, 96, 512, None),
                  (False, 8, False, 16, 64, "unpadded"),
                  (True, 8, True, 16, 64, "pos8")]
        own = torch.Generator(device=dev).manual_seed(12)
        for cont, H, qk, t0, B, variant in cases:
            N = 6 * MDN_MIXTURES + 3 if cont else V
            r, g = (randn, gen) if variant is None else (
                randn_from(own, dev), own)
            ops = chunk_operands(r, g, dev, B=B, L=L, d=d, H=H,
                                 dff=dff, N=N, Tmax=T, Mq=Mq, K=K, t0=t0,
                                 dtype=dtype, cont=cont)
            if variant != "unpadded":
                ops["head_w"], ops["head_b"] = dc.pad_head(
                    ops["head_w"], ops["head_b"], cont=cont)
            if variant == "pos8":
                off = 8 // ops["pos_chunk"].element_size()
                pos = torch.empty(K * d + off, dtype=dtype, device=dev)[off:]
                ops["pos_chunk"] = pos.view(K, d).copy_(ops["pos_chunk"])
            kv_ref = (ops["k_cache"].clone(), ops["v_cache"].clone())
            kname = "decode_cont_chunk" if cont else "decode_chunk"
            kw = dict(num_heads=H, qk_norm=qk)
            if cont:
                kw["num_mixtures"] = MDN_MIXTURES
            routes = dict(dc.ROUTES)
            got = getattr(dc, kname)(
                *chunk_args(ops, ops["k_cache"], ops["v_cache"], cont), **kw)
            torch.cuda.synchronize()
            route = ("cluster" if dtype == torch.bfloat16 and variant is None
                     else "rows")
            if dc.ROUTES != {**routes, route: routes[route] + 1}:
                fail(f"{kname} {tag} B={B} H={H}: launched on "
                     f"{dc.ROUTES} (before {routes}), not the {route} kernel")
            if dtype == torch.float32:
                *want, margins = getattr(dc, f"{kname}_reference")(
                    *chunk_args(ops, *kv_ref, cont), **kw,
                    return_margins=True)
                tie = margins < 1
                n = torch.where(tie.any(1), tie.int().argmax(1), K)
                checked = steps[None] < n[:, None]
                kv_rows = steps[None] <= n[:, None]
                rule = "free-running, up to each row's first near tie"
            else:
                want, margins = plain_fed_kernel_picks(kname, ops, got,
                                                       kv_ref, kw, cont)
                checked = margins >= BF16_TIE_ULPS
                kv_rows = torch.ones_like(checked)
                rule = "plain fed the kernel's picks, away from near ties"
            name = (f"{kname} {tag} B={B} L={L} d={d} H={H} dff={dff} "
                    f"N={ops['head_b'].shape[0]} K={K} t0={t0} qk_norm={qk}"
                    f"{'' if variant is None else ' ' + variant} on the "
                    f"{route} kernel ({rule})")
            err = held_to_plain(name, got[:-1], want[:-1], margins, checked,
                                (ops["k_cache"], ops["v_cache"]), kv_ref,
                                kv_rows, t0, dtype)
            if not torch.equal(ops["k_cache"][:, :, :t0],
                               kv_ref[0][:, :, :t0]):
                fail(f"{name}: cache rows below t0 changed")
            main_shape = H == 8 and qk == cont and B == 64 and variant is None
            if main_rec and main_shape:
                errs[kname] = max(errs[kname], err)


# ---------------------------------------------------------------------------
# the training stacks' kernels (K3 / K4 / K5)
# ---------------------------------------------------------------------------

# cont2cont_mdn (sketchformer_tpu_torch/presets.py): the trunk of the main
# path; cont_train: the JAX benchmark's continuous training shape
MDN = dict(B=64, T=192, d=256, H=8, dff=512, L=8)
CONT_TRAIN = dict(B=512, T=96, d=256, H=2, dff=512, L=8)
TRAIN_STEPS = 30
# sum_rows launches a cont2cont_mdn step while linear_tn's partials and the
# bias gradients each took a sum_rows launch (this script's train path on
# an NVIDIA H100 80GB HBM3, 11,760 in 30 steps), and while the attention
# backward's qk-norm partials took two a call (4,080 in 30 steps)
SUM_ROWS_PER_STEP_BEFORE = 392
SUM_ROWS_PER_STEP_BEFORE_K5 = 136
# ... and while LayerNorm's parameter gradients took one a call (1,200 in
# 30 steps; the token steps 80 a step)
SUM_ROWS_PER_STEP_BEFORE_LN = 40
SUM_ROWS_PER_TOK_STEP_BEFORE_LN = 80
# the float32 train main path (cont2cont_mdn, 2 of its 8 layers): its
# attention backward's qk-norm partial rows are the one main-path caller of
# sum_rows
F32_TRAIN_STEPS = 3
F32_TRAIN_LAYERS = 2
# the f32 attention backward's qk-norm partial rows at cont2cont_mdn: B * H
# * T / 16 rows of (dscale, dbias) (the first pass, 16 query rows a block)
K5_F32_PARTIALS = (64 * 8 * 192 // 16, 2 * 32)
# the bf16 attention backward's modes: (B, Tq, Tk) self-attention at T = 1,
# 96, 192 and 1024 and cross-attention to Mq = 4 memory rows, at each head
# width the tensor-core kernel is built for (H * Dh = 2 heads)
K5_SHAPES = ((4, 1, 1), (4, 96, 96), (4, 192, 192), (1, 1024, 1024),
             (4, 192, 4))
K5_HEAD_DIMS = (32, 64, 128)
# the bf16 stacks' kernels (sum_rows runs on the f32 path only)
TRAIN_KERNELS = ("linear_nt", "linear_tn", "attention_fwd", "attention_bwd_q",
                 "attention_bwd_kv", "layernorm_bwd")
TOK_KERNELS = ("token_ce_fwd", "token_ce_dx", "token_ce_dw",
               "emit_dropout_bits")
# pretrain_full's shards: per-class npz files in the sketch-rnn release's
# layout, of synthetic sketches (the QuickDraw files are not in the repo),
# through the port's prep-data: 345 x 24 = 8,280 sketches, 90% train in
# shards of 1,024 -> 8 train shards, 4 for each of the 2 ranks
QD_CLASSES, QD_PER_CLASS, QD_SHARD_SIZE = 345, 24, 1024
# the 2-rank run of pretrain_full (then its eval), the dropout-0 trajectory
# against one process, and world size 1 on NCCL against a run without a group
DDP_RANKS, DDP_STEPS, DDP_TRAJ_STEPS = 2, 10, 3
# the trajectory's warmup: the learning rate climbs to 1.1e-3 at its 3rd
# step (d 256), so that the loss moves (by 3.7%); past the 3rd step the
# bf16 runs' error grows (2.1e-4 at the 4th, 7.1e-4 at the 6th). Its
# tolerance, set from readings (PERF.md, PR 15), halfway in ratio between
# the sound 2-rank run's largest error (3.4e-5) and that of one process
# averaging the ranks' local means at the same batches (1.4e-4)
DDP_TRAJ_WARMUP, DDP_TRAJ_TOL = 30, 7e-5
DDP_TIMEOUT = 300.0   # seconds a rank may take; a hung rank fails the phase
STACK_KERNELS = ("linear", "layernorm_rows", "encoder_attention") + \
    TRAIN_KERNELS


def train_operands(randn, dev, *, B, T, d, H, dff, dtype, qk):
    """Random operands of one layer's backward at a stack's shapes: rows,
    gradients, weights, dropout bytes and attention inputs."""
    import torch

    M, HD, Dh = B * T, d, d // H
    gen = torch.Generator(device=dev).manual_seed(7)
    byt = lambda *s: torch.randint(0, 256, s, dtype=torch.uint8,
                                   generator=gen, device=dev)
    lengths = torch.randint(T // 4, T + 1, (B,), generator=gen, device=dev)
    lengths[0] = T
    bias = torch.where(torch.arange(T, device=dev)[None] < lengths[:, None],
                       0.0, -1e9).float()
    qkv = randn(B, T, 3 * HD, dtype=dtype)
    norms = tuple(1.0 + randn(Dh, scale=0.1) if i % 2 == 0 else
                  randn(Dh, scale=0.1) for i in range(4)) if qk else None
    return dict(
        x=randn(M, d, dtype=dtype), h=randn(M, dff, dtype=dtype),
        g=randn(M, d, dtype=dtype), g32=randn(M, d), gf=randn(M, dff),
        gqkv=randn(M, 3 * HD),
        f1=torch.relu(randn(M, dff, dtype=dtype)),
        wqkv=randn(d, 3 * HD, scale=d ** -0.5, dtype=dtype),
        wo=randn(HD, d, scale=HD ** -0.5, dtype=dtype),
        w1=randn(d, dff, scale=d ** -0.5, dtype=dtype),
        w2=randn(dff, d, scale=dff ** -0.5, dtype=dtype),
        drop=byt(M, d), thresh=26, ks=1.0 / (1.0 - 26 / 256.0),
        q=qkv[..., :HD], k=qkv[..., HD:2 * HD], v=qkv[..., 2 * HD:],
        bias=bias, norms=norms, do=randn(B, T, HD),
        mem_k=randn(B, 4, 2 * HD, dtype=dtype),
        scale=1.0 + randn(d, scale=0.1), bvec=randn(d, scale=0.1))


def layer_nt_calls(o, fn):
    """The four input-gradient products of one encoder layer's backward."""
    def run():
        ks = dict(drop=o["drop"], thresh=o["thresh"], keep_scale=o["ks"])
        return [fn(o["g"], o["w2"], gate=o["f1"], **ks),
                fn(o["gf"], o["w1"]),
                fn(o["g32"], o["wo"], **ks),
                fn(o["gqkv"], o["wqkv"])]
    return run


def layer_tn_calls(o, fn, drop=None):
    """The four weight-gradient products of one encoder layer's backward,
    each with its bias gradient: [(dW, db)] x 4. ``drop`` replaces the
    dropout bytes (a ``PrngSite`` draws them in-kernel)."""
    def run():
        ks = dict(drop=o["drop"] if drop is None else drop,
                  thresh=o["thresh"], keep_scale=o["ks"], bias_grad=True)
        return [fn(o["f1"], o["g"], **ks), fn(o["x"], o["gf"], bias_grad=True),
                fn(o["x"], o["g32"], **ks),
                fn(o["x"], o["gqkv"], bias_grad=True)]
    return run


def attn_calls(o, H, qk, which, mod):
    """One attention call of the backward's recompute / backward."""
    q, k, v, bias = o["q"], o["k"], o["v"], o["bias"]
    norms = o["norms"] if qk else None
    kw = dict(num_heads=H, qk_norm=norms)
    ref = "_reference" if mod == "plain" else ""
    import sketchformer_tpu_torch.ops.attention_train as at

    if which == "fwd":
        return lambda: getattr(at, "attention_fwd" + ref)(q, k, v, bias,
                                                          norm_p=True, **kw)
    if which == "bwd_q":
        return lambda: getattr(at, "attention_bwd_q" + ref)(q, k, v, o["do"],
                                                            bias, **kw)
    stats = at.attention_bwd_q_reference(q, k, v, o["do"], bias, **kw)[1]
    return lambda: getattr(at, "attention_bwd_kv" + ref)(
        q, k, v, o["do"], bias, stats, **kw)


def check_train_kernels(randn, gen, dev, errs, compare):
    """Each training kernel against its plain version at the cont2cont_mdn
    width (H=8/Dh=32, qk-norm) and at H=2/Dh=128 without qk-norm, f32 and
    bf16; then each whole stack's forward and backward, in f32 on each of
    the input draws of ``stack_draws``."""
    import torch

    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack as es

    B, T, d, dff = (MDN[k] for k in ("B", "T", "d", "dff"))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for H, qk in ((8, True), (2, False)):
            main = dtype == torch.bfloat16 and H == 8
            o = train_operands(randn, dev, B=B, T=T, d=d, H=H, dff=dff,
                               dtype=dtype, qk=qk)
            shape = f"{tag} B={B} T={T} d={d} H={H} qk_norm={qk}"
            if H == 8:   # the products and norms do not depend on H
                got = layer_nt_calls(o, es.linear_nt)()
                want = layer_nt_calls(o, es.linear_nt_reference)()
                for i, (g, w) in enumerate(zip(got, want)):
                    compare(f"linear_nt {shape} call {i}", g, w, dtype,
                            "linear_nt" if main else None)
                # linear_tn: dW and db of each call, 'bits' and 'prng'
                # masks, and bit-equal re-runs (the splits' partials are
                # added in a fixed order)
                site = dp.PrngSite(PRNG_SEED, 3, 1, T)
                for mode, drop in (("bits", None), ("prng", site)):
                    got = layer_tn_calls(o, es.linear_tn, drop)()
                    again = layer_tn_calls(o, es.linear_tn, drop)()
                    want = layer_tn_calls(o, es.linear_tn_reference, drop)()
                    for i, (g, w, a) in enumerate(zip(got, want, again)):
                        for part, gp, wp, ap in zip(("dW", "db"), g, w, a):
                            compare(f"linear_tn {mode} {shape} call {i} "
                                    f"{part}", gp, wp, dtype,
                                    "linear_tn" if main else None)
                            if not torch.equal(gp, ap):
                                fail(f"linear_tn {mode} {shape} call {i} "
                                     f"{part}: two runs differ")
                    print(f"check linear_tn {mode} {shape}: dW and db of 4 "
                          f"calls equal across two runs")
                ks = dict(drop=o["drop"], thresh=o["thresh"],
                          keep_scale=o["ks"])
                compare(f"linear+dropout {shape}",
                        es.linear(o["h"], o["w2"], o["bvec"], residual=o["x"],
                                  **ks),
                        es.linear_reference(o["h"], o["w2"], o["bvec"],
                                            residual=o["x"], **ks), dtype)
            for which, name in (("fwd", "attention_fwd"),
                                ("bwd_q", "attention_bwd_q"),
                                ("bwd_kv", "attention_bwd_kv")):
                got = attn_calls(o, H, qk, which, "kernel")()
                want = attn_calls(o, H, qk, which, "plain")()
                if which == "fwd" and dtype == torch.bfloat16:
                    # each output row has one owner in the mma.sync kernel
                    if not torch.equal(got, attn_calls(o, H, qk, which,
                                                       "kernel")()):
                        fail(f"attention_fwd {shape}: two runs differ")
                    print(f"check attention_fwd {shape}: equal across two "
                          f"runs")
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for i, (g, w) in enumerate(zip(got, want)):
                    if g is None:
                        continue
                    part = f"{name} {shape} out {i}"
                    if which == "bwd_kv" and qk and i == 3:
                        # the k-norm bias shifts every key alike: its
                        # gradient is zero up to rounding, held at the
                        # k-norm scale gradient's magnitude
                        compare(part, g, w, dtype, None,
                                scale=want[2].abs().max().item())
                    else:
                        compare(part, g, w, dtype, name if main and i == 0
                                else None)
            # cross-attention over the Mq = 4 memory rows
            ck, cv = o["mem_k"][..., :d], o["mem_k"][..., d:]
            from sketchformer_tpu_torch.ops import attention_train as at
            kw = dict(num_heads=H, qk_norm=o["norms"])
            compare(f"attention_fwd cross Mq=4 {shape}",
                    at.attention_fwd(o["q"], ck, cv, None, **kw),
                    at.attention_fwd_reference(o["q"], ck, cv, None, **kw),
                    dtype)
            gq = at.attention_bwd_q(o["q"], ck, cv, o["do"], None, **kw)
            wq = at.attention_bwd_q_reference(o["q"], ck, cv, o["do"], None,
                                              **kw)
            compare(f"attention_bwd_q cross Mq=4 {shape}", gq[0], wq[0],
                    dtype)
            gkv = at.attention_bwd_kv(o["q"], ck, cv, o["do"], None, wq[1],
                                      **kw)
            wkv = at.attention_bwd_kv_reference(o["q"], ck, cv, o["do"], None,
                                                wq[1], **kw)
            for i in (0, 1):
                compare(f"attention_bwd_kv cross Mq=4 {shape} out {i}",
                        gkv[i], wkv[i], dtype)
            del o
        draws = stack_draws(randn, gen, dev, dtype)
        check_norm_kernels(dev, dtype, compare)
        for decoder in (False, True):
            for H, qk in ((8, True), (2, False)):
                check_train_stack(draws, dev, decoder, H, qk, dtype)
    check_attention_bwd_modes(randn, dev)


def stack_draws(randn, gen, dev, dtype):
    """[(label, randn)]: the input draws the whole-stack checks run on. In
    bf16 the shared stream. In f32 also two more, each drawn in the same
    order by the four stack checks: the shared stream as it stood before
    ``check_norm_kernels`` took its own generator (advanced by that check's
    operands), and a fresh seed."""
    import torch

    if dtype != torch.float32:
        return [("shared", randn)]
    ahead = torch.Generator(device=dev)
    ahead.set_state(gen.get_state())
    randn_ahead = randn_from(ahead, dev)
    draw_norm_operands(randn_ahead, dtype)
    return [("shared", randn),
            ("shared after the norm operands", randn_ahead),
            ("seed 11", randn_from(torch.Generator(device=dev).manual_seed(
                11), dev))]


NORM_SHAPES = ((MDN["B"] * MDN["T"], MDN["d"]), (1000, 128), (300, 96))
SUM_ROWS_SHAPES = ((MDN["B"] * MDN["T"], 3 * MDN["d"]), K5_F32_PARTIALS,
                   (1000, 70))


def draw_norm_operands(randn, dtype):
    """The operands of ``check_norm_kernels`` in draw order: per
    NORM_SHAPES (rows, D) x, dy, the scale and a residual of each dtype;
    then the ``sum_rows`` rows of each dtype at SUM_ROWS_SHAPES."""
    import torch

    f32 = torch.float32
    dtypes = (f32,) if dtype == f32 else (f32, dtype)
    ln = []
    for rows, D in NORM_SHAPES:
        x, dy = randn(rows, D, dtype=dtype), randn(rows, D)
        s = 1.0 + randn(D, scale=0.1)
        resids = {"none": None}
        for rt in dtypes:
            resids[str(rt)[6:]] = randn(rows, D, dtype=rt)
        ln.append((x, dy, s, resids))
    rows = [(rt, randn(R, N, dtype=rt)) for rt in dtypes
            for R, N in SUM_ROWS_SHAPES]
    return dtypes, ln, rows


def check_norm_kernels(dev, dtype, compare):
    """``layernorm_bwd`` (dx, dscale, dbias) in every residual (none, f32,
    the compute dtype) and output dtype, at the cont2cont_mdn rows (M
    12,288, D 256), at D 128 and at a ragged D 96 (the column loop), and
    ``sum_rows`` on f32 and compute-dtype rows at the (12,288, 768) pane,
    the f32 attention backward's qk-norm partial rows and a ragged (1,000,
    70): each within TOL of its plain version and torch.equal across two
    runs; ``layernorm_bwd`` launches no ``sum_rows``. Records the bf16
    ``layernorm_bwd`` error at D 256 and the ``sum_rows`` error on the f32
    partial rows (its main path). Its operands come from a generator of
    its own, so the checks after it keep their inputs."""
    import torch

    from sketchformer_tpu_torch.ops import norm_train as nt

    f32 = torch.float32
    tag = str(dtype).replace("torch.", "")
    d = MDN["d"]
    dtypes, ln, sums = draw_norm_operands(
        randn_from(torch.Generator(device=dev).manual_seed(10), dev), dtype)
    for (rows, D), (x, dy, s, resids) in zip(NORM_SHAPES, ln):
        n = 0
        for rname, r in resids.items():
            for out in dtypes:
                kw = dict(resid=r, out_dtype=out)
                before = nt.LAUNCHES["sum_rows"]
                got = nt.layernorm_bwd(x, dy, s, **kw)
                again = nt.layernorm_bwd(x, dy, s, **kw)
                if nt.LAUNCHES["sum_rows"] != before:
                    fail("layernorm_bwd launched sum_rows")
                want = nt.layernorm_bwd_reference(x, dy, s, **kw)
                name = (f"layernorm_bwd {tag} M={rows} D={D} resid {rname} "
                        f"out {str(out)[6:]}")
                rec = "layernorm_bwd" if dtype != f32 and D == d else None
                for part, g, w, a in zip(("dx", "dscale", "dbias"), got,
                                         want, again):
                    compare(f"{name} {part}", g, w,
                            out if part == "dx" else f32, rec)
                    if not torch.equal(g, a):
                        fail(f"{name} {part}: two runs differ")
                n += 1
        print(f"check layernorm_bwd {tag} M={rows} D={D}: {n} residual / "
              f"output combinations equal across two runs, no sum_rows")
    for rt, x in sums:
        R, N = x.shape
        got, again = nt.sum_rows(x), nt.sum_rows(x)
        name = f"sum_rows {str(rt)[6:]} rows ({R}, {N})"
        compare(name, got, nt.sum_rows_reference(x), f32,
                "sum_rows" if rt == f32 and (R, N) == K5_F32_PARTIALS
                else None)
        if not torch.equal(got, again):
            fail(f"{name}: two runs differ")
        print(f"check {name}: equal across two runs")


def check_attention_bwd_modes(randn, dev):
    """The bf16 attention backward (K5, both passes on the tensor cores)
    against its plain versions in every mode: self-attention with and
    without causal and cross-attention to 4 memory rows, with and without a
    key bias (a fully masked batch element) and qk-norm, at T = 1, 96, 192
    and 1024 and Dh 32, 64 and 128; dq, dk, dv and the qk-norm gradients
    equal across two runs; and no sum_rows launch."""
    import torch

    from sketchformer_tpu_torch.ops import attention_train as at
    from sketchformer_tpu_torch.ops import norm_train as nt

    bf, H = torch.bfloat16, 2
    tol = TOL["bfloat16"]
    for B, Tq, Tk in K5_SHAPES:
        for Dh in K5_HEAD_DIMS:
            HD = H * Dh
            q = randn(B, Tq, 3 * HD, dtype=bf)[..., :HD]
            kv = randn(B, Tk, 2 * HD, dtype=bf)
            k, v = kv[..., :HD], kv[..., HD:]
            do = randn(B, Tq, HD, dtype=bf)
            lengths = torch.tensor([Tk, (Tk + 1) // 2, 0, Tk][:B], device=dev)
            masked = torch.where(torch.arange(Tk, device=dev)[None] <
                                 lengths[:, None], 0.0, at.NEG_INF).float()
            norms = tuple(1.0 + randn(Dh, scale=0.1) if i % 2 == 0 else
                          randn(Dh, scale=0.1) for i in range(4))
            worst, n = 0.0, 0
            for bias in (None, masked):
                for causal in ((False, True) if Tq == Tk else (False,)):
                    for qk in (None, norms):
                        kw = dict(num_heads=H, causal=causal, qk_norm=qk)
                        rows = nt.LAUNCHES["sum_rows"]
                        got = at.attention_bwd_q(q, k, v, do, bias, **kw)
                        again = at.attention_bwd_q(q, k, v, do, bias, **kw)
                        want = at.attention_bwd_q_reference(q, k, v, do,
                                                            bias, **kw)
                        got += at.attention_bwd_kv(q, k, v, do, bias,
                                                   want[1], **kw)
                        again += at.attention_bwd_kv(q, k, v, do, bias,
                                                     want[1], **kw)
                        want += at.attention_bwd_kv_reference(
                            q, k, v, do, bias, want[1], **kw)
                        torch.cuda.synchronize()
                        if nt.LAUNCHES["sum_rows"] != rows:
                            fail("the bf16 attention backward launched "
                                 "sum_rows")
                        mode = (f"B={B} Tq={Tq} Tk={Tk} Dh={Dh} key_bias="
                                f"{bias is not None} causal={causal} "
                                f"qk_norm={qk is not None}")
                        # dq, stats, dq-norm (2), dk, dv, dk-norm (2); the
                        # k-norm bias gradient is zero up to rounding (held
                        # at the k-norm scale gradient's size), and at T = 1
                        # every gradient but dv is exactly 0 (held at 1)
                        for i, (g, a, w) in enumerate(zip(got, again, want)):
                            if w is None:
                                continue
                            if not torch.equal(g, a):
                                fail(f"attention_bwd {mode} out {i}: two "
                                     f"runs differ")
                            ref = want[6] if i == 7 else w
                            size = ref.abs().max().item() or 1.0
                            rel = (g.float() - w.float()).abs().max().item() \
                                / size
                            if not (torch.isfinite(g).all() and rel <= tol):
                                fail(f"attention_bwd {mode} out {i}: rel err "
                                     f"{rel:.3e} above {tol:.0e}")
                            worst = max(worst, rel)
                            n += 1
            print(f"check attention_bwd (bf16, mma.sync) B={B} Tq={Tq} "
                  f"Tk={Tk} H={H} Dh={Dh}: {n} outputs in every mode, worst "
                  f"rel err {worst:.3e} (tol {tol:.0e}), each equal across "
                  f"two runs, no sum_rows")


def stack_module(dev, decoder, H, qk, dtype, L=2, seed=0):
    """A pre-LN stack module at the cont2cont_mdn width with seeded random
    parameters (f32, as the port keeps them)."""
    import torch

    from sketchformer_tpu_torch.models.transformer import Decoder, Encoder

    d, dff = MDN["d"], MDN["dff"]
    mod = (Decoder if decoder else Encoder)(L, H, d, dff, dtype, "pallas",
                                           True, qk, 0.1).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            base = 1.0 if name.endswith("scale") else 0.0
            scale = 0.05 if "kernel" in name else 0.1
            p.copy_(base + torch.randn(p.shape, generator=gen, device=dev)
                    * scale)
    return mod


def stack_grads(mod, x, mem, km, gy, drop, decoder, H, qk, ops, dtype):
    """Output and the gradients of (x, memory, every parameter) of one
    forward + backward of the train stack on ``ops``; ``drop`` is the
    dropout bytes, or the stack's dropout keyword arguments."""
    import torch

    from sketchformer_tpu_torch.ops import decoder_stack_train as dst
    from sketchformer_tpu_torch.ops import encoder_stack_train as est

    mod = mod.to(dtype=torch.float32)
    for m in mod.modules():
        if hasattr(m, "dtype"):
            m.dtype = dtype
    w = mod.stacked_weights(grad=True)
    xi = x.detach().to(dtype).requires_grad_(True)
    inputs = [xi]
    dkw = drop if isinstance(drop, dict) else dict(dropout_bytes=drop)
    if decoder:
        mi = mem.detach().to(dtype).requires_grad_(True)
        inputs.append(mi)
        y = dst.fused_decoder_stack_train(
            xi, mi, km, None, w, num_heads=H, qk_norm=qk, dropout_rate=0.1,
            ops=ops, **dkw)
    else:
        y = est.fused_encoder_stack_train(
            xi, km, w, num_heads=H, qk_norm=qk, dropout_rate=0.1, ops=ops,
            **dkw)
    names = ["x", "memory"][:len(inputs)] + [
        n for n, _ in mod.named_parameters()]
    grads = torch.autograd.grad((y.float() * gy).sum(),
                                inputs + list(mod.parameters()),
                                allow_unused=True)
    return [("y", y)] + [(n, g) for n, g in zip(names, grads)
                         if g is not None]


# f32 whole stacks: the bound on each output's relative L2 error against
# the plain version, and on the gates the plain path may take from the
# kernels, per kind (see check_train_stack)
STACK_F32_L2 = 1e-3
STACK_F32_GATE_FLIPS = {"relu": 64, "nt": 8}


def gate_recording_ops(ops, gates):
    """``ops`` with the gates of its ReLU products (``linear`` with relu:
    output > 0) and of its gated input-gradient products (``linear_nt``'s
    gate > 0) appended to ``gates["relu"]`` / ``gates["nt"]`` in call
    order."""
    def linear(a, w, bias, *, relu=False, **kw):
        y = ops.linear(a, w, bias, relu=relu, **kw)
        if relu:
            gates["relu"].append(y > 0)
        return y

    def linear_nt(a, w, *, gate=None, **kw):
        if gate is not None:
            gates["nt"].append(gate > 0)
        return ops.linear_nt(a, w, gate=gate, **kw)

    return ops._replace(linear=linear, linear_nt=linear_nt)


def gate_imposing_ops(ops, gates, flips):
    """``ops`` whose ReLU products and gated input-gradient products take
    the recorded ``gates`` in call order: a ReLU product returns
    torch.where(gate, its own pre-activation, 0), ``linear_nt`` gates by
    the recorded gate. ``flips`` counts, per kind, the gates that its own
    values would have set otherwise."""
    import torch

    order = {k: iter(v) for k, v in gates.items()}

    def linear(a, w, bias, *, relu=False, **kw):
        if not relu:
            return ops.linear(a, w, bias, **kw)
        if kw.get("residual") is not None or kw.get("drop") is not None:
            fail("a ReLU product with a residual or dropout")
        pre = ops.linear(a, w, bias, **kw)
        gate = next(order["relu"])
        flips["relu"] += int(((pre > 0) != gate).sum())
        return torch.where(gate, pre, torch.zeros_like(pre))

    def linear_nt(a, w, *, gate=None, **kw):
        if gate is not None:
            want = next(order["nt"])
            flips["nt"] += int(((gate > 0) != want).sum())
            gate = want.to(gate.dtype)
        return ops.linear_nt(a, w, gate=gate, **kw)

    return ops._replace(linear=linear, linear_nt=linear_nt)


def check_train_stack(draws, dev, decoder, H, qk, dtype):
    """A whole train stack (L=2, cont2cont_mdn width, dropout on), kernels
    against the plain versions, the output and every gradient, on the
    inputs of each of ``draws`` ([(label, randn)]).

    f32: a relative L2 error within STACK_F32_L2, not 1e-4 of the largest
    element, with the plain path gated as the kernels gated it. A ReLU
    pre-activation within rounding of zero is gated differently by two
    summation orders (about one a run at these sizes, 12.6M
    pre-activations a stack); a flipped gate moves its row of the input
    gradient by up to 2.5e-3 of the largest element, more than summation
    order alone. So the kernel path runs first and records each ReLU
    product's gate and each gate ``linear_nt`` applies; the plain path then
    takes those gates (``gate_imposing_ops``) and computes everything else
    itself, which leaves only the two summation orders; the run prints how
    many gates differed before they were imposed and fails past
    STACK_F32_GATE_FLIPS, so a kernel that gates wrongly is not copied
    into the plain path. Every kernel alone is
    held to 1e-4 of the largest element above. bf16: held to the f32
    computation of the same inputs, at most STACK_BF16_FACTOR x the plain
    bf16 path's relative L2 error. A key bias (projection or k-norm) shifts
    a row's keys alike, so its gradient is zero up to rounding: it is held
    to 1e-4 (f32) of the largest gradient."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack_train as est

    B, T, d = MDN["B"], MDN["T"], MDN["d"]
    L = 2
    tag = str(dtype).replace("torch.", "")
    name = (f"fused_{'decoder' if decoder else 'encoder'}_stack_train fwd+bwd "
            f"{tag} L={L} B={B} T={T} d={d} H={H} qk_norm={qk} dropout 0.1")
    mod = stack_module(dev, decoder, H, qk, dtype)
    gen = torch.Generator(device=dev).manual_seed(3)
    km = torch.arange(T, device=dev)[None] < torch.randint(
        T // 4, T + 1, (B,), generator=gen, device=dev)[:, None]
    drop = torch.randint(0, 256, ((3 if decoder else 2) * L, B, T, d),
                         dtype=torch.uint8, generator=gen, device=dev)
    zero = ("key.bias", "k_norm.bias")
    l2 = lambda a, b: (a.float() - b.float()).norm().item() / max(
        b.float().norm().item(), 1e-30)

    def stack_args(randn):   # x, memory and the output gradient, drawn
        x, mem, gy = randn(B, T, d), randn(B, 4, d), randn(B, T, d)
        return (mod, x, mem, km, gy, drop, decoder, H, qk)

    if dtype == torch.float32:
        for label, randn in draws:
            args = stack_args(randn)
            gates = {"relu": [], "nt": []}
            flips = {"relu": 0, "nt": 0}
            got = stack_grads(*args, gate_recording_ops(est.KERNELS, gates),
                              dtype)
            want = stack_grads(*args,
                               gate_imposing_ops(est.PLAIN, gates, flips),
                               dtype)
            torch.cuda.synchronize()
            for kind, limit in STACK_F32_GATE_FLIPS.items():
                if not flips[kind] <= limit:
                    fail(f"{name} ({label}): {flips[kind]} {kind} gates of "
                         f"the kernel path differ from the plain path's "
                         f"(at most {limit})")
            top = max(w.abs().max().item() for _, w in want[1:])
            worst_l2 = worst_max = 0.0
            for (n, g), (_, r) in zip(got, want):
                if not torch.isfinite(g).all():
                    fail(f"{name} ({label}): {n} not finite")
                diff = (g - r).abs()
                if n.endswith(zero):
                    if not diff.max().item() <= TOL["float32"] * top:
                        fail(f"{name} ({label}): {n} differs by "
                             f"{diff.max().item():.3e}")
                    continue
                worst_max = max(worst_max, diff.max().item()
                                / max(r.abs().max().item(), 1e-30))
                worst_l2 = max(worst_l2, l2(g, r))
                if not l2(g, r) <= STACK_F32_L2:
                    fail(f"{name} ({label}): {n} rel L2 err {l2(g, r):.3e}")
            n_relu = sum(int(g.numel()) for g in gates["relu"])
            print(f"check {name} (draw: {label}): output and {len(got) - 1} "
                  f"gradients, worst rel L2 err {worst_l2:.3e} (<= "
                  f"{STACK_F32_L2:.0e}), worst max-element rel err "
                  f"{worst_max:.3e}; the plain path took the kernels' gates: "
                  f"{flips['relu']} of {n_relu} ReLU gates and {flips['nt']} "
                  f"linear_nt gates differed before (at most "
                  f"{STACK_F32_GATE_FLIPS['relu']} and "
                  f"{STACK_F32_GATE_FLIPS['nt']})")
        return
    (_, randn), = draws
    args = stack_args(randn)
    got = stack_grads(*args, est.KERNELS, dtype)
    want = stack_grads(*args, est.PLAIN, dtype)
    ref = stack_grads(*args, est.PLAIN, torch.float32)
    top = max(w.norm().item() for _, w in ref[1:])
    worst = 0.0
    for (n, g), (_, p), (_, r) in zip(got, want, ref):
        if not torch.isfinite(g).all():
            fail(f"{name}: {n} not finite")
        scale = top if n.endswith(zero) else max(r.float().norm().item(),
                                                 1e-30)
        err_k = (g.float() - r.float()).norm().item() / scale
        err_p = (p.float() - r.float()).norm().item() / scale
        worst = max(worst, err_k / max(err_p, 1e-30))
        if not err_k <= STACK_BF16_FACTOR * err_p:
            fail(f"{name}: {n} kernel L2 error {err_k:.3e} vs float32 above "
                 f"{STACK_BF16_FACTOR} x the plain path's {err_p:.3e}")
    print(f"check {name}: output and {len(got) - 1} gradients vs float32, "
          f"worst kernel/plain L2 error ratio {worst:.2f} (<= "
          f"{STACK_BF16_FACTOR})")


def train_main_path(cli, counters, engines, tmp, post_ln=False):
    """The port's train CLI on cont2cont_mdn for TRAIN_STEPS steps, then
    eval on its checkpoint, each with every launch counter reset just
    before and read just after. ``post_ln``: the post-LN model, whose
    stacks decline their kernels and whose self-attention, 16 calls a step
    (8 encoder and 8 decoder layers), runs K8 forward and backward.
    Returns (train launches, steps)."""
    import torch

    run = os.path.join(tmp, "run")
    argv = ["train", "--preset", "cont2cont_mdn", "--run-dir", run,
            "--device", "cuda", "--notifier", "none",
            "--loop-arg", f"total_steps={TRAIN_STEPS}",
            "--loop-arg", "log_every=1", "--loop-arg", "eval_every=1000",
            "--loop-arg", f"save_every={TRAIN_STEPS}"]
    if post_ln:
        argv += POST_LN
    engines.reset_seen()
    for m in counters:
        m.reset_launches()
    print("main path: python -m sketchformer_tpu_torch.cli " + " ".join(argv))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for m in counters for k, v in m.LAUNCHES.items()}
    if rc != 0:
        fail(f"cli train returned {rc}")
    final = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  train: {json.dumps(final)} ({secs:.1f} s)")
    print(f"  launches: {json.dumps(launches)}")
    main_path_routes("cli train")
    composed = sorted(s for s in engines._seen
                      if s[0] in ("encoder-stack", "decoder-stack")
                      and s[1] == "composed")
    if post_ln:
        calls = 2 * 8 * TRAIN_STEPS
        if launches["flash_attention_bwd"] < calls or \
                launches["flash_attention_fwd"] < calls:
            fail(f"K8 launched fewer than {calls} times forward and "
                 f"backward in {TRAIN_STEPS} post-LN steps")
        for k in STACK_KERNELS:
            if launches[k]:
                fail(f"the post-LN model launched stack kernel {k}")
        want = [(s, "composed", "post-LN config")
                for s in ("decoder-stack", "encoder-stack")]
        if composed != want:
            fail(f"post-LN stacks' engine notes {composed}")
    else:
        for k in STACK_KERNELS:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched by cli train")
        if composed:
            fail(f"a stack declined its kernels: {composed}")
    # LayerNorm's and the bf16 attention backward's parameter gradients are
    # summed in their own launches
    if launches["sum_rows"]:
        fail(f"cli train launched sum_rows {launches['sum_rows']} times")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r and "val_loss" not in r]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"train losses {losses}")
    last = float(np.mean(losses[-5:]))
    print(f"  losses {' '.join(f'{v:.3f}' for v in losses)}")
    print(f"  loss at step 1 {losses[0]:.4f}, mean of the last 5 steps "
          f"{last:.4f}; skipped steps "
          f"{sum(r.get('skipped_nonfinite', 0) for r in recs):.0f}")
    if not last < losses[0]:
        fail("the training loss did not fall")
    if not all(np.isfinite(v) for v in final.values()):
        fail(f"final eval metrics not finite: {final}")
    # eval on the checkpoint
    for m in counters:
        m.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["eval", "--run-dir", run, "--device", "cuda"])
    torch.cuda.synchronize()
    got = {k: v for m in counters for k, v in m.LAUNCHES.items()}
    if rc != 0:
        fail(f"cli eval returned {rc}")
    ev = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"main path: python -m sketchformer_tpu_torch.cli eval --run-dir "
          f"{run} --device cuda\n  eval: {json.dumps(ev)}\n  launches: "
          f"{json.dumps(got)}")
    main_path_routes("cli eval")
    for k in (("flash_attention_fwd",) if post_ln else
              ("linear", "layernorm_rows", "encoder_attention",
               "attention_fwd")):
        if got[k] <= 0:
            fail(f"kernel {k} was not launched by cli eval")
    if not all(np.isfinite(v) for v in ev.values()):
        fail(f"eval metrics not finite: {ev}")
    # the same checkpoint through the composed model (plain torch): the eval
    # loss of the kernels' forward within the bf16 tolerance
    args = cli.build_parser().parse_args(["eval", "--run-dir", run,
                                          "--device", "cuda"])
    model, loader = cli.restore_for_eval(args)
    from sketchformer_tpu_torch.train.loop import evaluate
    from sketchformer_tpu_torch.train.step import make_eval_step

    batches = loader.get_validation_set(max_batches=2)
    k_ev = evaluate(make_eval_step(model), batches)
    set_attn_impl(model, "xla")
    p_ev = evaluate(make_eval_step(model), batches)
    rel = abs(k_ev["loss"] - p_ev["loss"]) / abs(p_ev["loss"])
    print(f"check eval loss, kernels {k_ev['loss']:.5f} vs composed "
          f"{p_ev['loss']:.5f} (2 batches): rel {rel:.3e} (tol "
          f"{TOL['bfloat16']:.0e})")
    if not rel <= TOL["bfloat16"]:
        fail("the kernels' eval loss differs from the composed model's")
    return launches, TRAIN_STEPS


def train_f32_main_path(cli, counters, tmp):
    """The port's train CLI on cont2cont_mdn in float32, cut to
    F32_TRAIN_LAYERS of its 8 layers and F32_TRAIN_STEPS steps, with every
    launch counter reset just before and read just after: the stacks run
    their f32 kernels, and the attention backward's FMA passes leave their
    qk-norm parameter gradients as partial rows that ``sum_rows`` adds (its
    one caller on a main path). Returns the launches."""
    import torch

    run = os.path.join(tmp, "run_f32")
    argv = ["train", "--preset", "cont2cont_mdn", "--run-dir", run,
            "--device", "cuda", "--notifier", "none", "--hparams",
            f"dtype=float32,num_layers={F32_TRAIN_LAYERS}",
            "--loop-arg", f"total_steps={F32_TRAIN_STEPS}",
            "--loop-arg", "log_every=1", "--loop-arg", "eval_every=1000",
            "--loop-arg", f"save_every={F32_TRAIN_STEPS}"]
    for m in counters:
        m.reset_launches()
    print("main path: python -m sketchformer_tpu_torch.cli " + " ".join(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k: v for m in counters for k, v in m.LAUNCHES.items()}
    if rc != 0:
        fail(f"cli train (float32) returned {rc}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if "loss" in r and "val_loss" not in r]
    print(f"  launches: {json.dumps(launches)}")
    main_path_routes("cli train (float32)")
    print(f"  losses {' '.join(f'{v:.3f}' for v in losses)}")
    if len(losses) != F32_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"float32 train losses {losses}")
    for k in ("sum_rows", "layernorm_bwd", "attention_bwd_q",
              "attention_bwd_kv"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by cli train (float32)")
    return launches


# ---------------------------------------------------------------------------
# token-mode training: the fused vocab-CE head (K6) and the in-kernel
# dropout draw (K7)
# ---------------------------------------------------------------------------

# the JAX benchmark's flagship train cell (bench.py:262-267, :371-376): d 256,
# L=8, H=2/Dh=128, dff 512, vocab 10,004, 345 classes, bf16, dropout 0.1, no
# qk-norm, B=512, T=96; train_h8 is the same at H=8 (bench.py:431-434)
TRAIN = dict(B=512, T=96, d=256, H=2, dff=512, L=8, V=10004, classes=345)
CE_F32_ROWS = 4096
# corr is compared where the plain version's top two f32 logits are further
# apart than this (the two sides sum the same f32 products in other orders)
CE_TIE = 1e-3
PRNG_SEED = 0x5EED_0000_0000_0042


def ce_operands(randn, gen, dev, M, d, V, dtype):
    """Rows, head kernel (f32 parameter), bias, targets and a row gradient
    of one CE call."""
    import torch

    return (randn(M, d, dtype=dtype), randn(d, V, scale=d ** -0.5),
            randn(V, scale=0.1),
            torch.randint(0, V, (M,), generator=gen, device=dev).int(),
            randn(M, scale=1.0 / M))


def check_token_ce(randn, gen, dev, errs, compare):
    """K6 against its plain version: bf16 at the train shape (M 49,152, d
    256, V 10,004) and f32 at M 4,096: ll and lse, dx, dW and db within
    TOL; corr equal away from near ties; and the bf16 kernel against the
    f32 computation of the same inputs."""
    import torch

    from sketchformer_tpu_torch.ops import token_ce as tce

    d, V = TRAIN["d"], TRAIN["V"]
    for dtype, M in ((torch.bfloat16, TRAIN["B"] * TRAIN["T"]),
                     (torch.float32, CE_F32_ROWS)):
        tag = str(dtype).replace("torch.", "")
        main = dtype == torch.bfloat16
        x, w, b, tgt, gll = ce_operands(randn, gen, dev, M, d, V, dtype)
        shape = f"{tag} M={M} d={d} V={V}"
        got = tce.token_ce_fwd(x, w, b, tgt)
        want = tce.token_ce_fwd_reference(x, w, b, tgt)
        compare(f"token_ce_fwd ll {shape}", got[0], want[0], dtype,
                "token_ce_fwd" if main else None)
        compare(f"token_ce_fwd lse {shape}", got[2], want[2], dtype)
        top2 = tce.logits_reference(x, w, b).topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > CE_TIE
        if not torch.equal(got[1][clear], want[1][clear]):
            fail(f"token_ce_fwd {shape}: corr differs away from a near tie")
        print(f"check token_ce_fwd corr {shape}: equal on {int(clear.sum())}"
              f" of {M} rows (top two logits > {CE_TIE:g} apart)")
        del top2
        gb = tce.token_ce_bwd(x, w, b, tgt, want[2], gll)
        wb = tce.token_ce_bwd_reference(x, w, b, tgt, want[2], gll)
        for name, g, r, rec in (("dx", gb[0], wb[0], "token_ce_dx"),
                                ("dW", gb[1], wb[1], "token_ce_dw"),
                                ("db", gb[2], wb[2], None)):
            compare(f"token_ce_bwd {name} {shape}", g, r, dtype,
                    rec if main else None)
        del wb
        if main:   # dx, dW and db each summed in one fixed order
            again = tce.token_ce_bwd(x, w, b, tgt, want[2], gll)
            for name, g, a in zip(("dx", "dW", "db"), gb, again):
                if not torch.equal(g, a):
                    fail(f"token_ce_bwd {name} {shape}: two runs differ")
            print(f"check token_ce_bwd dx, dW, db {shape}: equal across two "
                  f"runs")
            del again
        if main:   # the bf16 kernel against the f32 computation
            ref32 = tce.token_ce_fwd_reference(x.float(), w, b, tgt)
            compare(f"token_ce_fwd ll {shape} vs float32", got[0], ref32[0],
                    dtype)
            r32 = tce.token_ce_bwd_reference(x.float(), w, b, tgt, ref32[2],
                                             gll)
            for name, g, r in zip(("dx", "dW", "db"), gb, r32):
                compare(f"token_ce_bwd {name} {shape} vs float32", g, r,
                        dtype)
            del ref32, r32
        del x, w, gb, got, want
        torch.cuda.empty_cache()


# the redesigned bf16 kernels' modes: ce_dw at ragged M, every width and
# vocabularies that are not a multiple of 64; linear_nt at small ragged
# shapes and at each (N, K) of the stacks' calls, at a ragged M
DW_MODES = dict(M=(1, 127, 129, 49152), dp=(64, 128, 192, 256),
                V=(2003, 10004))
NT_SHAPES = ((333, 96, 80), (50, 36, 20), (12321, 256, 512),
             (12321, 512, 256), (12321, 256, 256), (12321, 768, 256))


def check_redesigned_modes(randn, gen, dev, compare):
    """bf16 ``ce_dw`` (dW and db) and ``linear_nt`` (a f32 or bf16; no
    mask, 'bits' and 'prng'; the f32 output, the ReLU gate, the bf16
    residual) against their plain versions within TOL in every mode, each
    torch.equal across two runs; K6's backward launches no ``sum_rows``."""
    import torch

    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack as es
    from sketchformer_tpu_torch.ops import norm_train as nt
    from sketchformer_tpu_torch.ops import token_ce as tce

    dt = torch.bfloat16
    n = 0
    for M in DW_MODES["M"]:
        for dp_ in DW_MODES["dp"]:
            for V in DW_MODES["V"]:
                x, w, b, tgt, gll = ce_operands(randn, gen, dev, M, dp_, V,
                                                dt)
                lse = tce.token_ce_fwd_reference(x, w, b, tgt)[2]
                before = nt.LAUNCHES["sum_rows"]
                got = tce.token_ce_bwd(x, w, b, tgt, lse, gll)
                again = tce.token_ce_bwd(x, w, b, tgt, lse, gll)
                if nt.LAUNCHES["sum_rows"] != before:
                    fail("token_ce_bwd launched sum_rows")
                want = tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll)
                for name, g, r, a in zip(("dW", "db"), got[1:], want[1:],
                                         again[1:]):
                    compare(f"ce_dw {name} bf16 M={M} dp={dp_} V={V}", g, r,
                            dt)
                    if not torch.equal(g, a):
                        fail(f"ce_dw {name} M={M} dp={dp_} V={V}: two runs "
                             f"differ")
                n += 1
                del x, w, got, again, want
    print(f"check ce_dw: {n} shapes, dW and db equal across two runs, no "
          f"sum_rows launch")
    torch.cuda.empty_cache()
    n = 0
    for M, N, K in NT_SHAPES:
        for mode in (None, "bits", "prng"):
            for a_f32 in (True, False):
                for epi in ("f32", "gate", "residual"):
                    a = randn(M, N, dtype=torch.float32 if a_f32 else dt)
                    w = randn(K, N, scale=N ** -0.5, dtype=dt)
                    kw = dict(thresh=26, keep_scale=1.0 / (1.0 - 26 / 256.0))
                    if mode == "bits":
                        kw["drop"] = torch.randint(0, 256, (M, N),
                                                   dtype=torch.uint8,
                                                   generator=gen, device=dev)
                    elif mode == "prng":
                        kw["drop"] = dp.PrngSite(PRNG_SEED, 2, 1, M)
                    if epi == "gate":
                        kw["gate"] = torch.relu(randn(M, K, dtype=dt))
                    elif epi == "residual":
                        kw.update(out_dtype=dt, residual=randn(M, K,
                                                               dtype=dt))
                    name = (f"linear_nt bf16 M={M} N={N} K={K} a "
                            f"{'f32' if a_f32 else 'bf16'} mask {mode} "
                            f"{epi}")
                    got = es.linear_nt(a, w, **kw)
                    again = es.linear_nt(a, w, **kw)
                    compare(name, got, es.linear_nt_reference(a, w, **kw),
                            dt)
                    if not torch.equal(got, again):
                        fail(f"{name}: two runs differ")
                    n += 1
    print(f"check linear_nt: {n} modes and shapes, each equal across two "
          f"runs")
    check_linear_modes(randn, gen, dev, compare)
    check_ce_fwd_modes(randn, gen, dev, compare)


# bf16 linear's modes: ragged M; (K, N) of every stack call, widths that are
# not a multiple of 128 and an unaligned K and N (zero columns added by the
# wrapper); the epilogues alone and together
LINEAR_M = (1, 127, 12288 + 5)
LINEAR_KN = ((256, 768), (256, 256), (256, 512), (512, 256), (512, 512),
             (256, 64), (256, 192), (100, 70))
LINEAR_EPILOGUES = ((), ("relu",), ("residual",), ("bits",), ("prng",),
                    ("relu", "residual", "bits"), ("relu", "residual", "prng"))


def check_linear_modes(randn, gen, dev, compare):
    """bf16 ``linear`` against its plain version within TOL at every
    LINEAR_M x LINEAR_KN x LINEAR_EPILOGUES case ('prng' where N is a
    multiple of 4), each torch.equal across two runs, and each 'prng' case
    torch.equal to the same call fed the plain Philox's bytes ('bits')."""
    import torch

    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack as es

    dt = torch.bfloat16
    n = 0
    for M in LINEAR_M:
        for K, N in LINEAR_KN:
            a = randn(M, K, dtype=dt)
            w = randn(K, N, scale=K ** -0.5, dtype=dt)
            b = randn(N, scale=0.1)
            res = randn(M, N, dtype=dt)
            site = dp.PrngSite(PRNG_SEED, 1, 1, M)
            byt = torch.randint(0, 256, (M, N), dtype=torch.uint8,
                                generator=gen, device=dev)
            for epi in LINEAR_EPILOGUES:
                if "prng" in epi and N % 4:
                    continue
                kw = dict(relu="relu" in epi, thresh=26,
                          keep_scale=1.0 / (1.0 - 26 / 256.0))
                if "residual" in epi:
                    kw["residual"] = res
                if "bits" in epi:
                    kw["drop"] = byt
                if "prng" in epi:
                    kw["drop"] = site
                name = (f"linear bf16 M={M} K={K} N={N} "
                        f"{'+'.join(epi) or 'plain epilogue'}")
                got = es.linear(a, w, b, **kw)
                again = es.linear(a, w, b, **kw)
                compare(name, got, es.linear_reference(a, w, b, **kw), dt)
                if not torch.equal(got, again):
                    fail(f"{name}: two runs differ")
                if "prng" in epi:
                    kw["drop"] = dp.site_bytes_reference(site, M, N, dev)
                    if not torch.equal(got, es.linear(a, w, b, **kw)):
                        fail(f"{name}: 'prng' differs from 'bits' fed the "
                             f"same bytes")
                n += 1
    print(f"check linear: {n} modes and shapes, each equal across two runs, "
          f"'prng' equal to 'bits'")


# bf16 ce_fwd's modes, and three columns of a row planted to tie exactly
# (one across lanes, one across vocab tiles) for the first-index argmax
CE_FWD_MODES = dict(M=(1, 127, 300), dp=(64, 128, 192, 256), V=(65, 10004))


def check_ce_fwd_modes(randn, gen, dev, compare):
    """bf16 ``token_ce_fwd`` against its plain version at every CE_FWD_MODES
    case: ll and lse within TOL, each torch.equal across two runs; corr
    equal wherever the plain version's top two logits are CE_TIE apart and
    on the rows whose top logit is a planted exact tie of columns 3, 60 and
    64 (targets on each of the three: only the first counts as correct)."""
    import torch

    from sketchformer_tpu_torch.ops import token_ce as tce

    dt = torch.bfloat16
    n = ties = hits = 0
    for M in CE_FWD_MODES["M"]:
        for d in CE_FWD_MODES["dp"]:
            for V in CE_FWD_MODES["V"]:
                x, w, b, tgt, _ = ce_operands(randn, gen, dev, M, d, V, dt)
                # equal columns and biases: equal logits in every row, the
                # row's top where x . W's column is large enough
                tie = [3, 60, 64]
                w[:, tie] = w[:, tie[:1]]
                b[tie] = 3.0
                rows = torch.arange(M, device=dev)
                tgt = torch.where(rows % 2 == 0, torch.tensor(
                    tie, device=dev, dtype=tgt.dtype)[rows % 3], tgt)
                got = tce.token_ce_fwd(x, w, b, tgt)
                again = tce.token_ce_fwd(x, w, b, tgt)
                want = tce.token_ce_fwd_reference(x, w, b, tgt)
                shape = f"bf16 M={M} dp={d} V={V}"
                compare(f"token_ce_fwd ll {shape}", got[0], want[0], dt)
                compare(f"token_ce_fwd lse {shape}", got[2], want[2], dt)
                for part, g, a in zip(("ll", "corr", "lse"), got, again):
                    if not torch.equal(g, a):
                        fail(f"token_ce_fwd {part} {shape}: two runs differ")
                top2 = tce.logits_reference(x, w, b).topk(2, dim=-1).values
                planted = top2[:, 0] == top2[:, 1]
                clear = ((top2[:, 0] - top2[:, 1]) > CE_TIE) | planted
                if not torch.equal(got[1][clear], want[1][clear]):
                    fail(f"token_ce_fwd {shape}: corr differs away from a "
                         f"near tie")
                n += 1
                ties += int(planted.sum())
                hits += int((got[1][planted] > 0).sum())
    if ties == 0:
        fail("token_ce_fwd: no row topped by the planted tie")
    print(f"check token_ce_fwd: {n} shapes, equal across two runs; corr "
          f"equal on {ties} rows topped by the planted exact tie ({hits} of "
          f"them with the first tied column as target) and away from near "
          f"ties")


def check_dropout_prng(dev, errs):
    """K7: the emit kernel bit-equal to the plain Philox at each of
    EMIT_CHECKS on the route it must take (``ROUTES``), and at the train
    shape's (2L, B, T, d) with the kept share within 1e-3 of 1 - 26/256;
    then each 'prng' train stack (L=2, cont2cont_mdn width: B=64, T=192,
    H=8, qk-norm; f32 and bf16) equal to the 'bits' stack fed the emitted
    bytes, output and every gradient (torch.equal)."""
    import torch

    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack_train as est

    for (Bs, Ts, ds_), route in EMIT_CHECKS:
        before = dict(dp.ROUTES)
        got = dp.emit_dropout_bits(PRNG_SEED, 1, 1, Bs, Ts, ds_, dev)
        want = dp.emit_dropout_bits_reference(PRNG_SEED, 1, 1, Bs, Ts, ds_,
                                              dev)
        torch.cuda.synchronize()
        name = f"emit_dropout_bits (B, T, d) = {(Bs, Ts, ds_)} (route {route})"
        if dp.ROUTES != {**before, route: before[route] + 1}:
            fail(f"{name}: routes {dp.ROUTES} (before {before})")
        if not torch.equal(got, want):
            fail(f"{name}: differs from the plain Philox")
        print(f"check {name}: bit-equal to the plain Philox")
    L, B, T, d = TRAIN["L"], TRAIN["B"], TRAIN["T"], TRAIN["d"]
    got = dp.emit_dropout_bits(PRNG_SEED, L, 2, B, T, d, dev)
    want = dp.emit_dropout_bits_reference(PRNG_SEED, L, 2, B, T, d, dev)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("emit_dropout_bits differs from the plain Philox")
    kept = (got >= 26).double().mean().item()
    print(f"check emit_dropout_bits (2L, B, T, d) = {tuple(got.shape)}: "
          f"bit-equal to the plain Philox; kept share {kept:.6f} (1 - "
          f"26/256 = {1 - 26 / 256:.6f})")
    if not abs(kept - (1 - 26 / 256)) <= 1e-3:
        fail(f"emit_dropout_bits kept share {kept}")
    print(f"  emit_dropout_bits routes: {json.dumps(dp.ROUTES)}")
    errs["emit_dropout_bits"] = 0.0
    del got, want
    B, T = MDN["B"], MDN["T"]
    gen = torch.Generator(device=dev).manual_seed(21)
    for dtype in (torch.float32, torch.bfloat16):
        for decoder in (False, True):
            mod = stack_module(dev, decoder, 8, True, dtype, seed=5)
            x = torch.randn((B, T, d), generator=gen, device=dev)
            mem = torch.randn((B, 4, d), generator=gen, device=dev)
            gy = torch.randn((B, T, d), generator=gen, device=dev)
            km = torch.arange(T, device=dev)[None] < torch.randint(
                T // 4, T + 1, (B,), generator=gen, device=dev)[:, None]
            byt = dp.emit_dropout_bits(PRNG_SEED, 2, 3 if decoder else 2, B,
                                       T, d, dev)
            args = (mod, x, mem, km, gy)
            est.DRAWS["draw_dropout_bytes"] = 0
            dp.reset_launches()
            prng = stack_grads(*args, dict(dropout_impl="prng",
                                           seed=PRNG_SEED), decoder, 8, True,
                               est.KERNELS, dtype)
            draws = dp.LAUNCHES["prng_draw"]
            bits = stack_grads(*args, byt, decoder, 8, True, est.KERNELS,
                               dtype)
            torch.cuda.synchronize()
            name = (f"prng vs bits fused_{'decoder' if decoder else 'encoder'}"
                    f"_stack_train {str(dtype)[6:]} L=2 B={B} T={T} d={d} H=8 "
                    f"qk_norm")
            if est.DRAWS["draw_dropout_bytes"] or not draws:
                fail(f"{name}: the prng stack drew a byte tensor or no site "
                     f"in-kernel")
            for (n, g), (_, r) in zip(prng, bits):
                if not torch.equal(g, r):
                    fail(f"{name}: {n} differs")
            print(f"check {name}: output and {len(prng) - 1} gradients equal "
                  f"(torch.equal); {draws} kernel launches drew in-kernel")
            del mod, prng, bits, byt


def write_quickdraw_npz(in_dir, classes, per_class, seed=0):
    """Per-class ``<name>.npz`` files in the sketch-rnn release's layout
    (``train`` / ``valid`` / ``test`` object arrays of stroke-3 sketches),
    of the port's synthetic sketches: what prep-data reads."""
    from sketchformer_tpu_torch.data import synthetic

    def objects(sketches):
        arr = np.empty(len(sketches), dtype=object)
        for i, sk in enumerate(sketches):
            arr[i] = sk
        return arr

    os.makedirs(in_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_valid = max(1, per_class // 12)
    cut = per_class - 2 * n_valid
    for c in range(classes):
        sks = [synthetic.generate_sketch(c, rng) for _ in range(per_class)]
        np.savez(os.path.join(in_dir, f"class_{c:03d}.npz"),
                 train=objects(sks[:cut]),
                 valid=objects(sks[cut:cut + n_valid]),
                 test=objects(sks[cut + n_valid:]))


def prep_shards(cli, tmp):
    """pretrain_full's shards: QD_CLASSES per-class npz files through the
    port's ``prep-data``; at least 2 train shards a rank."""
    from sketchformer_tpu_torch.data.shards import ShardedDataset

    in_dir, out_dir = os.path.join(tmp, "quickdraw"), os.path.join(tmp,
                                                                   "shards")
    t0 = time.perf_counter()
    write_quickdraw_npz(in_dir, QD_CLASSES, QD_PER_CLASS)
    argv = ["prep-data", "--input-dir", in_dir, "--out-dir", out_dir,
            "--shard-size", str(QD_SHARD_SIZE)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli prep-data returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    ds = ShardedDataset(out_dir)
    n_train = sum(1 for f in os.listdir(out_dir) if f.startswith("train_"))
    print(f"main path: python -m sketchformer_tpu_torch.cli "
          f"{' '.join(argv)}\n  prep-data: {json.dumps(out)}; "
          f"{n_train} train shards, {ds.num_classes} classes "
          f"({time.perf_counter() - t0:.1f} s with the npz files)")
    if out["classes"] != QD_CLASSES or \
            out["sketches"] != QD_CLASSES * QD_PER_CLASS:
        fail(f"prep-data wrote {out}")
    if n_train < 2 * DDP_RANKS:
        fail(f"prep-data wrote {n_train} train shards for {DDP_RANKS} ranks")
    return out_dir


def train_tok_main_path(cli, counters, engines, tmp, shards):
    """The port's train CLI on pretrain_full (token mode) for TRAIN_STEPS
    steps on the prep-data shards through the preset's own
    distributed_stroke3 loader, then eval on its checkpoint, each with
    every launch counter reset just before and read just after. Returns
    the train launches."""
    import dataclasses

    import torch

    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.ops import encoder_stack_train as est
    from sketchformer_tpu_torch.train.loop import evaluate
    from sketchformer_tpu_torch.train.step import make_eval_step

    run = os.path.join(tmp, "run_tok")
    argv = ["train", "--preset", "pretrain_full", "--data-dir", shards,
            "--run-dir", run, "--device", "cuda",
            "--notifier", "none", "--loop-arg", f"total_steps={TRAIN_STEPS}",
            "--loop-arg", "warmup_steps=500", "--loop-arg", "log_every=1",
            "--loop-arg", "eval_every=1000", "--loop-arg",
            f"save_every={TRAIN_STEPS}"]
    print("main path: python -m sketchformer_tpu_torch.cli " + " ".join(argv))
    print(f"  cuts: the preset's loader (distributed_stroke3, batch 256, "
          f"buckets 64/96/128/192) reads prep-data shards of "
          f"{QD_CLASSES * QD_PER_CLASS:,} synthetic sketches (the QuickDraw "
          f"files are not in the repo); warmup 10,000 -> 500 so that the "
          f"loss can move in {TRAIN_STEPS} steps; {TRAIN_STEPS} of 300,000 "
          "steps")
    engines.reset_seen()
    for m in counters:
        m.reset_launches()
    est.DRAWS["draw_dropout_bytes"] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for m in counters for k, v in m.LAUNCHES.items()}
    draws = est.DRAWS["draw_dropout_bytes"]
    if rc != 0:
        fail(f"cli train (token) returned {rc}")
    final = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  train: {json.dumps(final)} ({secs:.1f} s)")
    print(f"  launches: {json.dumps(launches)}; draw_dropout_bytes calls "
          f"{draws}")
    main_path_routes("cli train (token)")
    for k in STACK_KERNELS + TOK_KERNELS + ("prng_draw",):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by cli train (token)")
    if launches["sum_rows"]:
        fail(f"cli train (token) launched sum_rows {launches['sum_rows']} "
             f"times")
    if draws:
        fail(f"the token train path drew {draws} dropout byte tensors")
    composed = sorted(s for s in engines._seen
                      if s[0] in ("encoder-stack", "decoder-stack")
                      and s[1] == "composed")
    if composed:
        fail(f"a stack declined its kernels: {composed}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r and "val_loss" not in r]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"token train losses {losses}")
    last = float(np.mean(losses[-5:]))
    print(f"  losses {' '.join(f'{v:.3f}' for v in losses)}")
    print(f"  loss at step 1 {losses[0]:.4f}, mean of the last 5 steps "
          f"{last:.4f}; skipped steps "
          f"{sum(r.get('skipped_nonfinite', 0) for r in recs):.0f}")
    if not last < losses[0]:
        fail("the token training loss did not fall")
    if not all(np.isfinite(v) for v in final.values()):
        fail(f"final eval metrics not finite: {final}")
    for m in counters:
        m.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["eval", "--run-dir", run, "--device", "cuda"])
    torch.cuda.synchronize()
    got = {k: v for m in counters for k, v in m.LAUNCHES.items()}
    if rc != 0:
        fail(f"cli eval (token) returned {rc}")
    ev = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"main path: python -m sketchformer_tpu_torch.cli eval --run-dir "
          f"{run} --device cuda\n  eval: {json.dumps(ev)}\n  launches: "
          f"{json.dumps(got)}")
    main_path_routes("cli eval (token)")
    for k in ("linear", "layernorm_rows", "encoder_attention",
              "attention_fwd", "token_ce_fwd"):
        if got[k] <= 0:
            fail(f"kernel {k} was not launched by cli eval (token)")
    if not all(np.isfinite(v) for v in ev.values()):
        fail(f"token eval metrics not finite: {ev}")
    # the same checkpoint through the composed model (plain torch, the
    # chunked composed CE head): the kernels' eval loss within bf16 TOL
    args = cli.build_parser().parse_args(["eval", "--run-dir", run,
                                          "--device", "cuda"])
    model, loader = cli.restore_for_eval(args)
    batches = loader.get_validation_set(max_batches=2)
    k_ev = evaluate(make_eval_step(model), batches)
    composed = Sketchformer(dataclasses.replace(model.config,
                                                attn_impl="xla"))
    composed.load_state_dict(model.state_dict())
    composed.to(next(model.parameters()).device).eval()
    p_ev = evaluate(make_eval_step(composed), batches)
    rel = abs(k_ev["loss"] - p_ev["loss"]) / abs(p_ev["loss"])
    print(f"check token eval loss, kernels {k_ev['loss']:.5f} vs composed "
          f"{p_ev['loss']:.5f} (2 batches): rel {rel:.3e} (tol "
          f"{TOL['bfloat16']:.0e})")
    if not rel <= TOL["bfloat16"]:
        fail("the kernels' token eval loss differs from the composed model's")
    del model, composed
    return launches


def metrics_losses(run_dir):
    """(train losses by step, whether no (step, keys) record repeats) of a
    run dir's metrics.jsonl."""
    seen, losses = set(), []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            key = (rec["step"], tuple(sorted(k for k in rec if k != "time")))
            unique = key not in seen
            seen.add(key)
            if "loss" in rec and "val_loss" not in rec:
                losses.append(rec["loss"])
            if not unique:
                return losses, False
    return losses, True


def ddp_main_path(cli, shards, tmp, gpu):
    """Multi-process data parallelism on the card: the train CLI's body
    (``cli.train``) of pretrain_full (its full width: d 256, L 8, 8 heads,
    bf16, qk-norm, 'prng' dropout 0.1, K6; batch 256 a rank, buckets
    64-192) on the prep-data shards by DDP_RANKS ranks over gloo on the one
    card (``parallel/multiprocess.py``, each rank streaming its own
    shards), for DDP_STEPS steps and its eval: losses and params equal
    across ranks, one checkpoint and one metrics.jsonl, both ranks
    restoring the checkpoint, every rank's bf16 kernels launched, and
    ``cli eval --run-dir`` on the run dir giving rank 0's final eval. Then
    at dropout 0 and a learning rate that moves the loss, the 2-rank
    losses against one process on the concatenated 512-row batches, within
    DDP_TRAJ_TOL, which must not hold the same process averaging the
    ranks' local means; and world size 1 on NCCL against a run without a
    group, bit for bit. Returns rank 0's launches in the 2-rank run."""
    import torch

    from sketchformer_tpu_torch.convert import init_params
    from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.parallel import multiprocess as mp
    from sketchformer_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()

    def loop_args(steps, warmup=500):
        return ["--notifier", "none", "--loop-arg", f"total_steps={steps}",
                "--loop-arg", f"warmup_steps={warmup}", "--loop-arg",
                "log_every=1", "--loop-arg", "eval_every=1000",
                "--loop-arg", f"save_every={steps}"]

    def launch(name, n, args):
        work = os.path.join(tmp, name)
        t0 = time.perf_counter()
        res = mp.launch(work, n_processes=n, timeout=DDP_TIMEOUT,
                        scenario="train", device="cuda", data_dir=shards,
                        train_args=args)
        return res, os.path.join(work, "run"), time.perf_counter() - t0

    # 1. two ranks on the one card, the preset as it is
    args = ["--preset", "pretrain_full", *loop_args(DDP_STEPS)]
    res, run, secs = launch("ddp", DDP_RANKS, args)
    r0 = res[0]
    print(f"main path: parallel.multiprocess.launch({DDP_RANKS} ranks, "
          f"scenario='train', device='cuda') -> cli.train "
          f"{' '.join(args)} --data-dir {shards}")
    print(f"  backends {[r['backend'] for r in res]} on "
          f"{[r['device'] for r in res]}; {secs:.1f} s for the launch, "
          f"run_training {[round(r['seconds'], 2) for r in res]} s a rank "
          f"(two ranks sharing one card: no data-parallel scaling) [{gpu}]")
    print(f"  final eval (rank 0): {json.dumps(r0['final'])}")
    for r in res:
        print(f"  rank {r['process_index']} launches: "
              f"{json.dumps(r['launches'])}")
    if [r["backend"] for r in res] != ["gloo"] * DDP_RANKS:
        fail(f"ddp backends {[r['backend'] for r in res]}")
    if any(r["final"] != r0["final"] or
           r["params_digest"] != r0["params_digest"] for r in res):
        fail("ddp: final metrics or params differ across ranks")
    if any(r["ckpt_steps"] != [DDP_STEPS] or not r["restored_equal"]
           for r in res):
        fail(f"ddp: checkpoints {[r['ckpt_steps'] for r in res]}, restored "
             f"{[r['restored_equal'] for r in res]}")
    n_ckpt = sorted(os.listdir(os.path.join(run, "checkpoints")))
    jsonl = [f for f in os.listdir(run) if f.endswith(".jsonl")]
    losses, unique = metrics_losses(run)
    print(f"  run dir: checkpoints {n_ckpt}, {jsonl}, {len(losses)} loss "
          f"records (one writer: {unique}); losses "
          f"{' '.join(f'{v:.3f}' for v in losses)}")
    if n_ckpt != [str(DDP_STEPS)] or jsonl != ["metrics.jsonl"] or \
            not unique or len(losses) != DDP_STEPS or \
            not np.isfinite(losses).all():
        fail("ddp: the run dir does not hold one writer's records")
    for r in res:
        idle = [k for k in STACK_KERNELS + TOK_KERNELS + ("prng_draw",)
                if r["launches"][k] <= 0]
        if idle:
            fail(f"ddp rank {r['process_index']} did not launch {idle}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["eval", "--run-dir", run, "--device", "cuda"])
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    want = {k[len("val_"):]: v for k, v in r0["final"].items()}
    print(f"check cli eval --run-dir on the 2-rank run dir (its saved "
          f"loader, no data flags): {json.dumps(got)}")
    if rc != 0 or got.keys() != want.keys() or any(
            abs(got[k] - want[k]) > 6e-5 for k in want):
        fail("ddp: cli eval of the run dir differs from rank 0's final "
             "eval")

    # 2. dropout 0: the 2-rank trajectory against one process stepping over
    # the rank-ordered concatenations of the ranks' batches; beside it, the
    # same process stepping over the same batches as two microbatches of
    # the ranks' rows (accum_steps 2), whose loss and gradient are the
    # plain average of the ranks' local means: the fault global_shares
    # exists to prevent, which the tolerance must see. 3. world size 1
    # (NCCL on the card) against a run without a group: the kernels are
    # run-to-run deterministic, so bit for bit. Both launches run while
    # this process computes the references.
    targs = ["--preset", "pretrain_full", "--hparams", "dropout=0.0",
             *loop_args(DDP_TRAJ_STEPS, DDP_TRAJ_WARMUP)]
    oargs = ["--preset", "pretrain_full", *loop_args(DDP_TRAJ_STEPS)]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        traj = pool.submit(launch, "ddp_traj", DDP_RANKS, targs)
        world1 = pool.submit(launch, "world1", 1, oargs)
        cargs = cli.build_parser().parse_args(
            ["train", *targs, "--data-dir", shards, "--run-dir",
             os.path.join(tmp, "ref"), "--device", "cuda"])
        cfg, _ = cli.resolve_config(cargs)
        lname, lkw = cli._resolve_loader_config(cargs)
        streams = []
        for p in range(DDP_RANKS):
            ld = get_dataloader_by_name(lname)(**lkw, process_index=p,
                                               process_count=DDP_RANKS)
            it = ld.batch_iterator("train", epoch=0)
            streams.append([next(it) for _ in range(DDP_TRAJ_STEPS)])
        glob = [mp.concat_batches([s[i] for s in streams])
                for i in range(DDP_TRAJ_STEPS)]
        ref, fault = [], []
        for accum, out in ((1, ref), (DDP_RANKS, fault)):
            model = Sketchformer(cfg)
            model.load_state_dict(init_params(cfg, 0))
            step = make_train_step(create_train_state(
                model.to("cuda"), 0, DDP_TRAJ_WARMUP, 1.0),
                accum_steps=accum)
            out += [float(step(b)["loss"]) for b in glob]
            del model, step
        prun = os.path.join(tmp, "nogroup")
        plain_model, _ = cli.train(cli.build_parser().parse_args(
            ["train", *oargs, "--data-dir", shards, "--run-dir", prun,
             "--device", "cuda"]))
        plain = (metrics_losses(prun)[0],
                 mp.params_digest(plain_model.state_dict()))
        del plain_model
        _, trun, tsecs = traj.result()
        one, orun, osecs = world1.result()
    got, _ = metrics_losses(trun)

    def rels(xs):
        return [abs(a - b) / abs(b) for a, b in zip(xs, ref)]

    rel, off = rels(got), rels(fault)
    print(f"check ddp trajectory, dropout 0, warmup {DDP_TRAJ_WARMUP}, "
          f"{DDP_RANKS} ranks {' '.join(f'{v:.5f}' for v in got)} vs one "
          f"process on the concatenated batches ({DDP_RANKS} x 256 rows, "
          f"each padded to the longer bucket) "
          f"{' '.join(f'{v:.5f}' for v in ref)}: rel "
          f"{' '.join(f'{v:.3e}' for v in rel)} (tol {DDP_TRAJ_TOL:.0e}); "
          f"the average of the ranks' local means "
          f"{' '.join(f'{v:.5f}' for v in fault)}: rel "
          f"{' '.join(f'{v:.3e}' for v in off)} (launch {tsecs:.1f} s) "
          f"[{gpu}]")
    if len(got) != DDP_TRAJ_STEPS or not max(rel) <= DDP_TRAJ_TOL:
        fail("ddp: the 2-rank trajectory differs from one process's")
    if not max(off) > DDP_TRAJ_TOL:
        fail("ddp: the trajectory's tolerance cannot see the average of "
             "the ranks' local means on these batches")
    one_losses, _ = metrics_losses(orun)
    same = (one_losses, one[0]["params_digest"]) == plain
    print(f"check world size 1 on {one[0]['backend']} "
          f"({osecs:.1f} s): losses {' '.join(f'{v:.6f}' for v in one_losses)}"
          f"; without a group (cli.train) "
          f"{' '.join(f'{v:.6f}' for v in plain[0])}; bit-equal (losses "
          f"and params): {same}")
    if one[0]["backend"] != "nccl":
        fail(f"world size 1 on the card ran on {one[0]['backend']}")
    if not same:
        fail("world size 1 differs from the run without a group")
    return r0["launches"]


IMPORT_SEED = 5
IMPORT_KERNELS = ("linear", "encoder_attention", "layernorm_rows")
# the kernels of embed_dataset's packed stack (bf16, a card)
EMBED_KERNELS = ("linear", "ragged_attention", "layernorm_rows")


def import_main_path(cli, counters, tmp, gpu):
    """Phase 4h: the reference-weight importer's run dir served on the
    card. A made-up reference of ``init_params(cfg, IMPORT_SEED)`` at the
    ``ar_decode`` width (the config ``cli.resolve_config`` gives the
    preset: vocab and classes from its loader): an npz of ``ref/<i>`` names
    in a shuffled order, every 2-D leaf of unequal dims stored transposed.
    The importer (``tools/import_reference_weights.py``, in this process)
    dumps its template, the mapping is filled, and it imports the npz into
    a run dir. Then ``embed`` and ``decode`` on ``--run-dir`` and on
    ``--weights`` (the seeded state_dict saved by ``convert.save_npz``):
    the embeddings and the decoded strokes equal bit for bit, and the
    run-dir path launching the encoder kernels and ``decode_chunk``.
    Returns the phase's seconds."""
    import dataclasses

    import torch

    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.convert import init_params, save_npz
    from sketchformer_tpu_torch.tools import import_reference_weights as iw

    t0 = time.perf_counter()
    cfg, _ = cli.resolve_config(cli.build_parser().parse_args(
        ["decode", "--preset", "ar_decode", "--init-seed", "0"]))
    default = dataclasses.asdict(SketchformerConfig())
    hparams = ",".join(f"{k}={v}" for k, v in dataclasses.asdict(cfg).items()
                       if v != default[k])
    if iw.build_config(hparams) != cfg:
        fail(f"importer config from {hparams!r} is not ar_decode's {cfg}")

    def tool(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = iw.main(argv)
        if rc != 0:
            fail(f"import_reference_weights {argv[2:]} returned {rc}")
        return buf.getvalue().strip().splitlines()[-1]

    sd = init_params(cfg, IMPORT_SEED)
    seeded = os.path.join(tmp, "seeded.npz")
    save_npz(seeded, sd)
    tmpl, refs = os.path.join(tmp, "map.json"), os.path.join(tmp, "ref.npz")
    tool(["--hparams", hparams, "--dump-template", tmpl])
    with open(tmpl) as f:
        mapping = json.load(f)
    if set(mapping) != {k.replace(".", "/") for k in sd}:
        fail("the importer's template is not the model's state_dict")
    order = np.random.default_rng(IMPORT_SEED).permutation(len(mapping))
    weights, flipped = {}, 0
    for i, path in zip(order, sorted(mapping)):
        arr = sd[path.replace("/", ".")].numpy()
        spec = mapping[path]
        spec["ref"] = f"ref/{i}"
        if arr.ndim == 2 and arr.shape[0] != arr.shape[1]:
            arr, spec["transpose"] = arr.T, [1, 0]
            flipped += 1
        weights[spec["ref"]] = arr
    with open(tmpl, "w") as f:
        json.dump(mapping, f)
    np.savez(refs, **weights)
    run = os.path.join(tmp, "run")
    said = tool(["--hparams", hparams, "--weights", refs, "--mapping", tmpl,
                 "--out", run])
    print(f"main path: import_reference_weights at ar_decode's width "
          f"({len(mapping)} leaves, {flipped} stored transposed, shuffled "
          f"names): {said}")

    def serve(cmd, source, flags):
        """``cli <cmd>`` on ar_decode from ``source``, every counter reset
        just before and read just after; (output arrays, launches)."""
        out = os.path.join(tmp, f"{cmd}_{source}.npz")
        argv = [cmd, "--preset", "ar_decode", *flags, "--device", "cuda",
                "--output", out]
        for m in counters:
            m.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        got = {k: v for m in counters for k, v in m.LAUNCHES.items()}
        if rc != 0:
            fail(f"cli {' '.join(argv)} returned {rc}")
        main_path_routes(f"cli {cmd} ({source})")
        with np.load(out) as data:
            arrays = {k: data[k] for k in data.files}
        return arrays, got

    for cmd, needs in (("embed", EMBED_KERNELS),
                       ("decode", IMPORT_KERNELS + ("decode_chunk",))):
        ours, launched = serve(cmd, "run_dir", ["--run-dir", run])
        want, _ = serve(cmd, "weights", ["--weights", seeded])
        print(f"  cli {cmd} --run-dir: launches "
              + ", ".join(f"{k} {launched[k]}" for k in needs))
        for k in needs:
            if launched[k] <= 0:
                fail(f"kernel {k} was not launched by cli {cmd} --run-dir")
        if ours.keys() != want.keys():
            fail(f"cli {cmd}: outputs {sorted(ours)} != {sorted(want)}")
        for k, v in want.items():
            if not np.isfinite(v).all() or ours[k].shape != v.shape or \
                    ours[k].dtype != v.dtype or \
                    ours[k].tobytes() != v.tobytes():
                fail(f"cli {cmd}: {k} from the imported run dir is not bit "
                     f"for bit the seeded npz's")
        shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in want.items())
        print(f"  cli {cmd}: run dir == seeded npz, bit for bit ({shapes})")
    secs = time.perf_counter() - t0
    print(f"import phase: {secs:.1f} s [{gpu}]")
    return secs


def fmt_spread(t):
    return "n/a" if t is None else \
        f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})"


def kernel_spread(fn, names, n=SPREAD_CALLS):
    """``timing.kernel_spread``, a trace that kept too few events failing
    the run."""
    try:
        return timing.kernel_spread(fn, names, n)
    except timing.TraceTooShort as e:
        fail(str(e))


def linear_layer_calls(fn, x, hid, w, drops=({}, {})):
    """One encoder layer's four ``linear`` calls: QKV, the out-projection
    + x, FFN-in + ReLU, FFN-out + x; ``drops`` the dropout keyword
    arguments of the two residual calls (the training forward's sites)."""
    def run():
        fn(x, w["wqkv"], w["bqkv"])
        fn(x, w["wo"], w["bo"], residual=x, **drops[0])
        fn(x, w["w1"], w["b1"], relu=True)
        fn(hid, w["w2"], w["b2"], residual=x, **drops[1])
    return run


def linear_spreads(randn, gpu):
    """bf16 ``linear`` as one encoder layer's four calls (d 256, dff 512) at
    the sbir shape (B=64, T=192, M 12,288) and the train shape (B=512,
    T=96, M 49,152; also with the training forward's 'prng' dropout on the
    two residual calls): the median and spread of SPREAD_CALLS calls'
    device time of the kernel, the plain version and four ``addmm`` (no
    dropout), beside the bound; then each call alone beside its ``addmm``
    (the residual as its added term). Returns (ms, plain_ms, library_ms)
    at the sbir shape."""
    import torch

    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack as es

    dt = torch.bfloat16
    d, dff = SBIR["d"], SBIR["dff"]
    w = {"wqkv": randn(d, 3 * d, scale=d ** -0.5, dtype=dt),
         "wo": randn(d, d, scale=d ** -0.5, dtype=dt),
         "w1": randn(d, dff, scale=d ** -0.5, dtype=dt),
         "w2": randn(dff, d, scale=dff ** -0.5, dtype=dt),
         "bqkv": randn(3 * d, scale=0.1), "bo": randn(d, scale=0.1),
         "b1": randn(dff, scale=0.1), "b2": randn(d, scale=0.1)}
    out = None
    for B, T in ((64, SBIR["T"]), (CONT_TRAIN["B"], CONT_TRAIN["T"])):
        M = B * T
        x = randn(M, d, dtype=dt)
        hid = torch.relu(randn(M, dff, dtype=dt))

        def lib():
            for a, k, b in ((x, "wqkv", "bqkv"), (x, "wo", "bo"),
                            (x, "w1", "b1"), (hid, "w2", "b2")):
                torch.addmm(w[b].to(dt), a, w[k])

        b_ms, b_by = bound(*linear_layer_work(M, d, dff))
        modes = [("no dropout", ({}, {}))]
        if B != 64:
            ks = dict(thresh=26, keep_scale=1.0 / (1.0 - 26 / 256.0))
            modes.append(("'prng' dropout on the residual calls",
                          tuple(dict(drop=dp.PrngSite(PRNG_SEED, 0, k, T),
                                     **ks) for k in (0, 1))))
        with torch.no_grad():
            for label, drops in modes:
                sp = spread_ms(linear_layer_calls(es.linear, x, hid, w, drops),
                               linear_layer_calls(es.linear_reference, x, hid,
                                                  w, drops), lib)
                print(f"time linear (bf16, B={B}, T={T}, M={M}, d={d}, "
                      f"dff={dff}, the layer: 4 calls, {label}, device time, "
                      f"median of {SPREAD_CALLS}): kernel "
                      f"{fmt_spread(sp['kernel'])}, plain "
                      f"{fmt_spread(sp['plain'])}, library (4 addmm) "
                      f"{fmt_spread(sp['lib'])}; bound {b_ms:.4f} ms ({b_by}),"
                      f" kernel / bound {sp['kernel'][0] / b_ms:.2f}, kernel "
                      f"/ library {sp['kernel'][0] / sp['lib'][0]:.2f} "
                      f"[{gpu}]")
                if out is None:
                    out = (sp["kernel"][0], sp["plain"][0], sp["lib"][0])
            # each call alone: which of the four the layer's time goes to
            for label, a, k, b, res in (
                    ("QKV, N 768", x, "wqkv", "bqkv", None),
                    ("out-proj + x, N 256", x, "wo", "bo", x),
                    ("FFN-in, N 512", x, "w1", "b1", None),
                    ("FFN-out + x, K 512, N 256", hid, "w2", "b2", x)):
                one = spread_ms(
                    lambda: es.linear(a, w[k], w[b], residual=res), None,
                    lambda: torch.addmm(w[b].to(dt) if res is None else res,
                                        a, w[k]))
                print(f"time linear call {label} (M={M}, device time, "
                      f"median of {SPREAD_CALLS}): kernel "
                      f"{fmt_spread(one['kernel'])}, library (addmm) "
                      f"{fmt_spread(one['lib'])} [{gpu}]")
        del x, hid
    return out


def ce_fwd_spread(randn, gen, dev, gpu):
    """bf16 ``token_ce_fwd`` at the train shape (M 49,152, d 256, V
    10,004): the median and spread of SPREAD_CALLS calls' device time of
    the kernel, the plain version and the ``addmm`` of the logits, beside
    the bound. Returns (ms, plain_ms, library_ms)."""
    import torch

    from sketchformer_tpu_torch.ops import token_ce as tce

    M, d, V = TRAIN["B"] * TRAIN["T"], TRAIN["d"], TRAIN["V"]
    dt = torch.bfloat16
    x, w, b, tgt, _ = ce_operands(randn, gen, dev, M, d, V, dt)
    wd = w.to(dt)
    with torch.no_grad():
        sp = spread_ms(lambda: tce.token_ce_fwd(x, w, b, tgt),
                       lambda: tce.token_ce_fwd_reference(x, w, b, tgt),
                       lambda: torch.addmm(b.to(dt), x, wd))
    b_ms, b_by = bound(*token_kernel_work(M, d, V)["token_ce_fwd"])
    print(f"time token_ce_fwd (bf16, M={M}, d={d}, V={V}, device time, "
          f"median of {SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, "
          f"plain {fmt_spread(sp['plain'])}, library (addmm of the logits) "
          f"{fmt_spread(sp['lib'])}; bound {b_ms:.4f} ms ({b_by}), kernel / "
          f"bound {sp['kernel'][0] / b_ms:.2f}, kernel / library "
          f"{sp['kernel'][0] / sp['lib'][0]:.2f} [{gpu}]")
    del x, w
    torch.cuda.empty_cache()
    return sp["kernel"][0], sp["plain"][0], sp["lib"][0]


def token_ce_times(randn, gen, dev, gpu, paired):
    """K6 at the train shape (bf16, M 49,152, d 256, V 10,004): each kernel
    against its plain version and one PyTorch call of its product (the
    forward from ``ce_fwd_spread``). The backward wrapper launches both
    backward kernels; each one's time is its
    device time in a profiler trace of the wrapper, and both rows carry the
    plain backward's time (it computes dx, dW and db together): the median
    of SPREAD_CALLS calls' kernel events, beside the library call's median
    device time (``spread_ms``). Returns {kernel: (ms, plain_ms,
    library_ms)}."""
    import torch

    from sketchformer_tpu_torch.ops import token_ce as tce

    M, d, V = TRAIN["B"] * TRAIN["T"], TRAIN["d"], TRAIN["V"]
    dt = torch.bfloat16
    x, w, b, tgt, gll = ce_operands(randn, gen, dev, M, d, V, dt)
    wd = w.to(dt)
    lse = tce.token_ce_fwd(x, w, b, tgt)[2]
    dl = randn(M, V, scale=1e-3, dtype=dt)
    out = {}
    out["token_ce_fwd"] = ce_fwd_spread(randn, gen, dev, gpu)
    with torch.no_grad():
        k_ms, p_ms = paired(
            lambda: tce.token_ce_bwd(x, w, b, tgt, lse, gll),
            lambda: tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll),
            iters=3, warm=1)
        parts = kernel_spread(
            lambda: tce.token_ce_bwd(x, w, b, tgt, lse, gll),
            ("ce_dx_wgmma_kernel", "ce_dw_wgmma_kernel"))
        libs = {k: spread_ms(None, None, fn)["lib"] for k, fn in (
            ("dx", lambda: torch.matmul(dl, wd.t())),
            ("dw", lambda: torch.matmul(x.t(), dl)))}
        print(f"time token_ce_bwd (bf16, M={M}, d={d}, V={V}, the wrapper: "
              f"both kernels and the partial sums): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms [{gpu}]")
        for kname, lkey in (("ce_dx_wgmma_kernel", "dx"),
                            ("ce_dw_wgmma_kernel", "dw")):
            print(f"time {kname} (bf16, M={M}, d={d}, V={V}, device time, "
                  f"median of the {parts[kname][3]} of {SPREAD_CALLS} "
                  f"launches its trace kept): kernel "
                  f"{fmt_spread(parts[kname])}, library (matmul "
                  f"{'dl.W^T' if lkey == 'dx' else 'x^T.dl'}) "
                  f"{fmt_spread(libs[lkey])} [{gpu}]")
        out["token_ce_dx"] = (parts["ce_dx_wgmma_kernel"][0], p_ms,
                              libs["dx"][0])
        out["token_ce_dw"] = (parts["ce_dw_wgmma_kernel"][0], p_ms,
                              libs["dw"][0])
        own, tpu = (bound(fl, token_kernel_work(M, d, V)["token_ce_dw"][1])
                    for fl in (4 * M * d * V, 2 * M * d * V))
        print(f"bound ce_dw (bf16, M={M}, d={d}, V={V}): {own[0]:.4f} ms "
              f"({own[1]}) for its own work (the logits' recompute and the "
              f"dW product, 4 M d V), {tpu[0]:.4f} ms ({tpu[1]}) for the "
              f"TPU kernel's share (the dW product, 2 M d V); kernel / own "
              f"bound {parts['ce_dw_wgmma_kernel'][0] / own[0]:.2f} [{gpu}]")
    for name, (k_ms, p_ms, l_ms) in out.items():
        print(f"time {name} (bf16, M={M}, d={d}, V={V}): kernel {k_ms:.4f} "
              f"ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms [{gpu}]")
    del dl, x
    torch.cuda.empty_cache()
    # the backward's kernels at narrower widths of the same rows and vocab:
    # how their time scales with the work (4 M d V each)
    with torch.no_grad():
        for dn in (64, 128, 192):
            x, w, b, tgt, gll = ce_operands(randn, gen, dev, M, dn, V, dt)
            lse = tce.token_ce_fwd(x, w, b, tgt)[2]
            sw = kernel_spread(
                lambda: tce.token_ce_bwd(x, w, b, tgt, lse, gll),
                ("ce_dx_wgmma_kernel", "ce_dw_wgmma_kernel"))
            print(f"time token_ce_bwd at d={dn} (bf16, M={M}, V={V}, kernel "
                  f"events, median of those of {SPREAD_CALLS} its trace "
                  f"kept): " + ", ".join(
                      f"{k} {fmt_spread(v)} ({v[3]} kept), "
                      f"{4 * M * dn * V / v[0] / 1e9:.1f} TFLOP/s"
                      for k, v in sw.items()) + f" [{gpu}]")
            del x, w
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K8: per-op attention, the post-LN model's path; K13: the whole-step decode
# ---------------------------------------------------------------------------

# (B, T, H, Dh): the post-LN cont2cont_mdn width and the cont_train geometry
FLASH_SHAPES = {"cont2cont_mdn": (64, 192, 8, 32),
                "cont_train": (512, 96, 2, 128)}
FLASH_MODES = ("none", "key", "key_causal", "full", "full_shared",
               "legacy_key")
POST_LN = ["--hparams", "norm_first=False"]
STEP_LOOP = 32


def flash_operands(randn, gen, dev, dtype, mode, B, T, H, Dh):
    """One attention call's (q, k, v, g) (B, T, H, Dh) and its masks
    (mask, key_mask, causal) in ``mode``, with fully masked rows: batch
    element 0 has no key, and a full pane holds a query row with none."""
    import torch

    q, k, v, g = (randn(B, T, H, Dh, dtype=dtype) for _ in range(4))
    lengths = torch.randint(T // 4, T + 1, (B,), generator=gen, device=dev)
    lengths[0] = 0
    km = torch.arange(T, device=dev)[None] < lengths[:, None]
    mask, key_mask = None, None
    if mode in ("key", "key_causal"):
        key_mask = km
    elif mode == "legacy_key":
        mask = km[:, None, None, :]
    elif mode in ("full", "full_shared"):
        mask = torch.rand((B if mode == "full" else 1, 1, T, T),
                          generator=gen, device=dev) < 0.8
        mask[0, 0, 3] = False
    return q, k, v, g, mask, key_mask, mode == "key_causal"


def flash_plain(q, k, v, g, mask, key_mask, causal):
    """The plain versions' [out, dq, dk, dv]."""
    from sketchformer_tpu_torch.ops import flash_attention as fa

    B, T = q.shape[:2]
    bias = fa.structure_mask(mask, key_mask, B, T, T)
    return [fa.flash_attention_reference(q, k, v, bias, causal),
            *fa.flash_attention_bwd_reference(q, k, v, bias, g, causal)]


def flash_kernel_and_plain(q, k, v, g, mask, key_mask, causal):
    """The public flash_attention (autograd, the kernels) and the plain
    versions on the same inputs: (kernel [out, dq, dk, dv], plain [...])."""
    import torch

    from sketchformer_tpu_torch.ops import flash_attention as fa

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, mask=mask, key_mask=key_mask,
                             causal=causal)
    got = [out] + list(torch.autograd.grad(out, leaves, g))
    return got, flash_plain(q, k, v, g, mask, key_mask, causal)


def check_flash_attention(randn, gen, dev, errs, compare):
    """K8 against its plain version: the forward and the three gradients,
    every mask mode, at the post-LN cont2cont_mdn width and the cont_train
    geometry, f32 and bf16 (bf16 also held to the f32 computation of the
    same inputs within STACK_BF16_FACTOR x the plain bf16 path's error,
    the sums being T long); then T = 1024 at a small batch, and the
    decline past it (T = 1040) to the composed math, with no launch."""
    import torch

    from sketchformer_tpu_torch.models.attention import (
        causal_mask,
        combine_masks,
        dot_product_attention,
    )
    from sketchformer_tpu_torch.ops import flash_attention as fa

    parts = ("out", "dq", "dk", "dv")
    for label, (B, T, H, Dh) in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            for mode in FLASH_MODES:
                ops = flash_operands(randn, gen, dev, dtype, mode, B, T, H,
                                     Dh)
                got, want = flash_kernel_and_plain(*ops)
                main = (label == "cont2cont_mdn" and dtype == torch.bfloat16
                        and mode in ("key", "key_causal"))
                name = f"flash_attention {tag} {label} B={B} T={T} H={H} " \
                       f"Dh={Dh} {mode}"
                for i, (p, a, b) in enumerate(zip(parts, got, want)):
                    rec = None
                    if main:
                        rec = ("flash_attention_fwd" if i == 0
                               else "flash_attention_bwd")
                    compare(f"{name} {p}", a, b, dtype, rec)
                if dtype == torch.float32:
                    continue
                q, k, v, g, *masks = ops
                bias = fa.structure_mask(masks[0], masks[1], B, T, T)
                runs = [fa.flash_attention_bwd(q, k, v, bias, g, masks[2])
                        for _ in range(2)]
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    fail(f"{name}: two backward runs differ")
                if not torch.equal(
                        *(fa.flash_attention_fwd(q, k, v, bias, masks[2])
                          for _ in range(2))):
                    fail(f"{name}: two forward runs differ")
                print(f"check {name}: out and dq/dk/dv equal across two "
                      f"runs")
                ref = flash_plain(*(t.float() for t in (q, k, v, g)), *masks)
                for p, a, b, r in zip(parts[1:], got[1:], want[1:], ref[1:]):
                    err_k = (a.float() - r).abs().max().item()
                    err_p = (b.float() - r).abs().max().item()
                    if not err_k <= STACK_BF16_FACTOR * err_p + 1e-30:
                        fail(f"{name} {p}: kernel error {err_k:.3e} vs "
                             f"float32 above {STACK_BF16_FACTOR} x the "
                             f"plain path's {err_p:.3e}")
                print(f"check {name} dq/dk/dv vs float32: within "
                      f"{STACK_BF16_FACTOR} x the plain bf16 path's error")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for H, Dh in ((2, 128), (8, 32)):
            ops = flash_operands(randn, gen, dev, dtype, "key_causal", 2,
                                 fa.MAX_FUSED_LEN, H, Dh)
            got, want = flash_kernel_and_plain(*ops)
            for p, a, b in zip(parts, got, want):
                compare(f"flash_attention {tag} B=2 T={fa.MAX_FUSED_LEN} "
                        f"H={H} Dh={Dh} key_causal {p}", a, b, dtype)
            q, k, v, g, _, km, _ = ops
            bias = fa.structure_mask(None, km, 2, fa.MAX_FUSED_LEN,
                                     fa.MAX_FUSED_LEN)
            runs = [fa.flash_attention_bwd(q, k, v, bias, g, True)
                    for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"flash_attention {tag} T={fa.MAX_FUSED_LEN}: two "
                     f"backward runs differ")
    Tl = fa.MAX_FUSED_LEN + 16
    q, k, v, _, _, km, _ = flash_operands(randn, gen, dev, torch.bfloat16,
                                          "key", 1, Tl, 2, 32)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, key_mask=km, causal=True)
    torch.cuda.synchronize()
    want = dot_product_attention(q, k, v, mask=combine_masks(
        km[:, None, None, :], causal_mask(Tl, dev)))
    if fa.LAUNCHES != before or not torch.equal(got, want):
        fail(f"flash_attention at T={Tl}: expected the composed math with "
             f"no launch")
    print(f"check flash_attention bf16 T={Tl}: declined to the composed "
          f"math (no launch, equal)")


def step_operands(randn, gen, dev, dtype, H, qk, t, K=1, B=64):
    """Operands of one whole decode step (or K steps of the loop) at the
    ar_decode width, the cache rows from t on set to NaN: the step reads
    rows [0, t) only."""
    d, L, dff, V, T, Mq = (AR[k] for k in ("d", "L", "dff", "V", "T", "Mq"))
    ops = chunk_operands(randn, gen, dev, B=B, L=L, d=d, H=H, dff=dff, N=V,
                         Tmax=T, Mq=Mq, K=K, t0=t, dtype=dtype, cont=False)
    if K == 1:
        ops["k_cache"][:, :, t:] = float("nan")
        ops["v_cache"][:, :, t:] = float("nan")
    ops["x"] = randn(B, d, dtype=dtype)
    return ops


def plain_step_loop_fed(o, ids, kv, H):
    """The plain step loop one step at a time from the caches ``kv`` (its
    own new rows scattered into them), each step fed the kernel loop's pick
    (and finished state) of the step before: its picks and margins given
    the kernel's prefix."""
    import torch

    from sketchformer_tpu_torch.data.tokenizer import EOS_ID
    from sketchformer_tpu_torch.ops import decode_step as dstep

    prev, fin = o["prev"], o["finished"]
    picks, margins = [], []
    for j in range(ids.shape[1]):
        got, _, m = dstep.greedy_steps(
            prev, fin, *kv, o["cross_k"], o["cross_v"], o["emb"],
            o["pos_chunk"][j:j + 1], o["head_w"], o["head_b"], o["w"], j,
            num_heads=H, step=dstep.fused_decode_step_reference,
            return_margins=True)
        picks.append(got)
        margins.append(m)
        prev = ids[:, j].contiguous()
        fin = torch.where(prev == EOS_ID, 1, fin)
    return torch.cat(picks, 1), torch.cat(margins, 1)


def check_decode_step(randn, gen, dev, errs):
    """K13 against its plain version at the ar_decode width (L=8, d=256,
    dff=512, Tmax=192) for t = 0, 17 and 191, qk-norm off and on, at
    H=8/Dh=32 and H=2/Dh=128, at B=64 and at B=40 (a part-empty row group of
    the cluster kernel): h and the new k/v rows, f32 (the per-row kernel)
    within TOL, bf16 (8 layers deep; every launch on the cluster kernel's
    step kind, ``ROUTES``) held to the f32 computation of the same inputs
    within STACK_BF16_FACTOR x the plain bf16 path's error. Then a
    STEP_LOOP-step f32 greedy loop, one launch a step, against two
    decode_chunk launches from the same state (picks equal up to each row's
    first near tie of the plain version), and the bf16 loop against the
    plain bf16 step loop fed the kernel's picks, every step compared away
    from a near tie of BF16_TIE_ULPS ulps (as the bf16 chunks)."""
    import torch

    from sketchformer_tpu_torch.ops import decode_chunk as dc
    from sketchformer_tpu_torch.ops import decode_step as dstep

    T = AR["T"]
    cases = [(8, qk, t, 64) for qk in (False, True) for t in (0, 17, T - 1)]
    cases += [(2, False, 17, 64), (2, True, T - 1, 64), (8, True, 17, 40),
              (2, False, 0, 40), (8, False, T - 1, 40)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        tol = TOL[tag]
        route = "rows" if dtype == torch.float32 else "cluster"
        for H, qk, t, B in cases:
            o = step_operands(randn, gen, dev, dtype, H, qk, t, B=B)
            args = (o["x"], o["k_cache"], o["v_cache"], o["cross_k"],
                    o["cross_v"], o["w"], t)
            kw = dict(num_heads=H, qk_norm=qk)
            before = dict(dstep.ROUTES)
            got = dstep.fused_decode_step(*args, **kw)
            want = dstep.fused_decode_step_reference(*args, **kw)
            torch.cuda.synchronize()
            name = (f"decode_step {tag} B={B} L={AR['L']} d={AR['d']} H={H} "
                    f"Tmax={T} t={t} qk_norm={qk} (route {route})")
            if dstep.ROUTES != {**before, route: before[route] + 1}:
                fail(f"{name}: routes {dstep.ROUTES} (before {before})")
            if dtype == torch.bfloat16:
                ref = dstep.fused_decode_step_reference(
                    *(a.float() for a in args[:5]),
                    {k: v.float() for k, v in o["w"].items()}, t, **kw)
            worst = 0.0
            for part, a, b, *r in zip(("h", "k_new", "v_new"), got, want,
                                      *([ref] if dtype == torch.bfloat16
                                        else [])):
                if not torch.isfinite(a).all():
                    fail(f"{name}: {part} not finite")
                err = (a.float() - b.float()).abs().max().item()
                if H == 8 and not qk and B == 64 and dtype == torch.bfloat16:
                    errs["decode_step"] = max(errs["decode_step"], err)
                if dtype == torch.float32:
                    rel = err / b.abs().max().item()
                    worst = max(worst, rel)
                    if not rel <= tol:
                        fail(f"{name}: {part} rel err {rel:.3e}")
                    continue
                err_k = (a.float() - r[0]).abs().max().item()
                err_p = (b.float() - r[0]).abs().max().item()
                worst = max(worst, err_k / max(err_p, 1e-30))
                if not err_k <= STACK_BF16_FACTOR * err_p + 1e-30:
                    fail(f"{name}: {part} kernel error {err_k:.3e} vs "
                         f"float32 above {STACK_BF16_FACTOR} x the plain "
                         f"path's {err_p:.3e}")
            print(f"check {name}: " + (
                f"h, k_new, v_new worst rel err {worst:.3e} (tol {tol:.0e})"
                if dtype == torch.float32 else
                f"vs float32, worst kernel/plain error ratio {worst:.2f} "
                f"(<= {STACK_BF16_FACTOR})"))
    # the f32 step loop against the chunk kernel, from the same state
    K = STEP_LOOP
    o = step_operands(randn, gen, dev, torch.float32, 8, False, 0, K=K)
    kv = (o["k_cache"], o["v_cache"])
    clone = lambda: tuple(c.clone() for c in kv)
    head = (o["emb"], o["pos_chunk"], o["head_w"], o["head_b"], o["w"])
    kw = dict(num_heads=8)
    ids_step, _ = dstep.greedy_steps(o["prev"], o["finished"], *clone(),
                                     o["cross_k"], o["cross_v"], *head, 0,
                                     **kw)
    kc, vc = clone()
    prev, fin, chunks = o["prev"], o["finished"], []
    for t0 in range(0, K, AR["K"]):
        ids, fin = dc.decode_chunk(prev, fin, kc, vc, o["cross_k"],
                                   o["cross_v"], o["emb"],
                                   o["pos_chunk"][t0:t0 + AR["K"]],
                                   o["head_w"], o["head_b"], o["w"], t0, **kw)
        chunks.append(ids)
        prev = ids[:, -1].contiguous()
    ids_chunk = torch.cat(chunks, 1)
    *_, margins = dc.decode_chunk_reference(
        o["prev"], o["finished"], *clone(), o["cross_k"], o["cross_v"],
        *head, 0, **kw, return_margins=True)
    torch.cuda.synchronize()
    tie = margins < 1
    n = torch.where(tie.any(1), tie.int().argmax(1), K)
    checked = torch.arange(K, device=dev)[None] < n[:, None]
    compared = int(checked.sum())
    if compared < ids_step.numel() // 2:
        fail(f"step loop: only {compared} row-steps away from a near tie")
    if not torch.equal(ids_step[checked], ids_chunk[checked]):
        fail("step loop: picks differ from decode_chunk's away from ties")
    print(f"check greedy step loop f32 ({K} decode_step launches) vs "
          f"decode_chunk ({K // AR['K']} launches): picks equal on "
          f"{compared}/{ids_step.numel()} row-steps up to each row's first "
          f"near tie")
    # the bf16 step loop (the cluster kernel) against the plain step loop
    o = step_operands(randn, gen, dev, torch.bfloat16, 8, False, 0, K=K)
    kv = (o["k_cache"], o["v_cache"])
    clone = lambda: tuple(c.clone() for c in kv)
    head = (o["emb"], o["pos_chunk"], o["head_w"], o["head_b"], o["w"])
    before = dict(dstep.ROUTES)
    ids_k, _ = dstep.greedy_steps(o["prev"], o["finished"], *clone(),
                                  o["cross_k"], o["cross_v"], *head, 0, **kw)
    if dstep.ROUTES != {**before, "cluster": before["cluster"] + K}:
        fail(f"bf16 step loop: routes {dstep.ROUTES} (before {before})")
    ids_p, margins = plain_step_loop_fed(o, ids_k, clone(), 8)
    torch.cuda.synchronize()
    checked = margins >= BF16_TIE_ULPS
    compared = int(checked.sum())
    if compared < ids_k.numel() // 2:
        fail(f"bf16 step loop: only {compared} row-steps away from a near "
             f"tie")
    if not torch.equal(ids_k[checked], ids_p[checked]):
        bad = (ids_k != ids_p) & checked
        b, j = (int(i) for i in bad.nonzero()[0])
        fail(f"bf16 step loop: row {b} step {j} picks {int(ids_k[b, j])}, "
             f"the plain loop {int(ids_p[b, j])} (margin "
             f"{margins[b, j]:.3g})")
    print(f"check greedy step loop bf16 ({K} decode_step launches on the "
          f"cluster kernel) vs the plain step loop fed its picks: picks "
          f"equal on {compared}/{ids_k.numel()} row-steps away from a near "
          f"tie of {BF16_TIE_ULPS} ulps")


def flash_times(randn, gen, dev, gpu, paired):
    """K8 forward and backward (bf16, key mask) against the plain versions
    and SDPA with the same boolean mask (and its backward), at both
    FLASH_SHAPES: the median and spread of SPREAD_CALLS calls' device time.
    Returns {kernel: (ms, plain_ms, library_ms)} at the cont2cont_mdn
    width."""
    import torch
    import torch.nn.functional as F

    from sketchformer_tpu_torch.ops import flash_attention as fa

    out = {}
    for label, (B, T, H, Dh) in FLASH_SHAPES.items():
        q, k, v, g, _, km, _ = flash_operands(
            randn, gen, dev, torch.bfloat16, "key", B, T, H, Dh)
        bias = fa.structure_mask(None, km, B, T, T)
        q4, k4, v4, g4 = (t.transpose(1, 2) for t in (q, k, v, g))
        amask = km[:, None, None, :]
        leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        with torch.enable_grad():
            sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=amask)

        def lib_bwd():
            with torch.enable_grad():
                torch.autograd.grad(sdpa, leaves, g4, retain_graph=True)

        with torch.no_grad():
            sps = {
                "flash_attention_fwd": spread_ms(
                    lambda: fa.flash_attention_fwd(q, k, v, bias),
                    lambda: fa.flash_attention_reference(q, k, v, bias),
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=amask)),
                "flash_attention_bwd": spread_ms(
                    lambda: fa.flash_attention_bwd(q, k, v, bias, g),
                    lambda: fa.flash_attention_bwd_reference(
                        q, k, v, bias, g), lib_bwd)}
            host = paired(lambda: fa.flash_attention_bwd(q, k, v, bias, g),
                          lambda: fa.flash_attention_bwd_reference(
                              q, k, v, bias, g), iters=10)
        rows = {}
        for name, sp in sps.items():
            rows[name] = (sp["kernel"][0], sp["plain"][0], sp["lib"][0])
            lib_call = "SDPA backward" if "bwd" in name else "SDPA"
            print(f"time {name} ({label}: bf16, B={B}, T={T}, H={H}, "
                  f"Dh={Dh}, key mask, device time, median of "
                  f"{SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, "
                  f"plain {fmt_spread(sp['plain'])}, library ({lib_call}, "
                  f"the same boolean mask) {fmt_spread(sp['lib'])} [{gpu}]")
        print(f"time flash_attention_bwd ({label}) back to back with the "
              f"host's launches: kernel {host[0]:.4f} ms, plain "
              f"{host[1]:.4f} ms [{gpu}]")
        if label == "cont2cont_mdn":
            out = rows
        del sdpa, leaves
    return out


def cluster_barrier_us(dev, C, clusters, iters=20000):
    """Device microseconds of one cluster barrier of the bf16 chunk kernel
    (C blocks of 256 threads, ``clusters`` clusters at once): CUDA events
    around ``iters`` back-to-back barriers, less an empty launch."""
    import torch

    from sketchformer_tpu_torch.ops import decode_chunk as dc

    dc.cluster_barrier_probe(dev, C, clusters, 10)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    dc.cluster_barrier_probe(dev, C, clusters, 0)
    ev[1].record()
    ev[2].record()
    dc.cluster_barrier_probe(dev, C, clusters, iters)
    ev[3].record()
    torch.cuda.synchronize()
    return (ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])) \
        / iters * 1e3


# ---------------------------------------------------------------------------
# the work of each timed call, which ``timing.bound`` turns into the least
# time the card could take for it
# ---------------------------------------------------------------------------


def gemm_work(shapes, es_=2):
    """FLOPs and bytes of a list of (M, K, N, a_bytes, b_bytes, out_bytes,
    extra_bytes) products."""
    fl = by = 0
    for M, K, N, ab, bb, ob, extra in shapes:
        fl += 2 * M * K * N
        by += M * K * ab + K * N * bb + M * N * ob + extra
    return fl, by


def train_kernel_work(B, T, d, H, dff):
    """{kernel: (flops, bytes)} of the calls chip_smoke times for each
    training kernel (bf16, the cont2cont_mdn layer)."""
    M, HD, Dh = B * T, d, d // H
    u8 = M * d
    nt = gemm_work([(M, d, dff, 2, 2, 4, u8 + M * dff * 2),
                    (M, dff, d, 4, 2, 4, 0),
                    (M, d, HD, 4, 2, 4, u8),
                    (M, 3 * HD, d, 4, 2, 4, 0)])
    # linear_tn: each call's dW (f32) and db (N f32) written once
    tn = gemm_work([(dff, M, d, 2, 2, 4, u8 + d * 4),
                    (d, M, dff, 2, 4, 4, dff * 4),
                    (d, M, d, 2, 4, 4, u8 + d * 4),
                    (d, M, 3 * HD, 2, 4, 4, 3 * HD * 4)])
    qkv = 3 * M * HD * 2
    att = 4 * B * H * T * T * Dh
    return {
        "linear_nt": nt, "linear_tn": tn,
        "attention_fwd": (att, qkv + M * HD * 2 + B * T * 4),
        # dO in bf16 as the stacks pass it, the gradients in f32
        "attention_bwd_q": (1.5 * att, qkv + M * HD * (2 + 4) + B * H * T * 12),
        "attention_bwd_kv": (2 * att, qkv + M * HD * (2 + 8) + B * H * T * 12),
        **norm_work(M, d, *K5_F32_PARTIALS),
    }


def linear_layer_work(M, d, dff):
    """(flops, bytes) of one encoder layer's four ``linear`` calls (bf16):
    QKV, the out-projection and FFN-out with their residuals, FFN-in."""
    return gemm_work([(M, d, 3 * d, 2, 2, 2, 0), (M, d, d, 2, 2, 2, M * d * 2),
                      (M, d, dff, 2, 2, 2, 0),
                      (M, dff, d, 2, 2, 2, M * d * 2)])


def serving_kernel_work(B, T, d, H, dff, L, V, K, N_mdn, Mq=4):
    """{kernel: (flops, bytes)} of the timed calls of the serving kernels
    (bf16): linear = one encoder layer's 4 products; encoder_attention one
    call at (B, T); decode chunks the mean 16-step chunk of a T=192
    decode (layernorm_rows' and decode_attention's: ``rule2_work``).

    A chunk's K steps each re-read every filled k/v cache row of every
    layer (position t reads rows 0..t: (T + 1) / 2 on average over the
    decode), so those bytes count once a step: the cache grows by a row
    each step and at B=64 holds ~55 MB, which no design keeps on chip. The
    weights and the Mq cross K/V rows (constant over the chunk, ~2 MB at
    B=64) count once a chunk, as do the embedding rows the steps read, the
    new cache rows and the picks."""
    M, Dh = B * T, d // H
    lin = linear_layer_work(M, d, dff)
    trunk_w = L * (d * 3 * d + 3 * d * d + 2 * d * dff) * 2
    t_mean = (T + 1) / 2
    per_row = (L * 2 * (d * 3 * d + 3 * d * d + 2 * d * dff)
               + L * 4 * (t_mean + Mq) * d)

    def chunk(N, emb_rows):
        fl = K * B * (per_row + 2 * d * N)
        by = (trunk_w + d * N * 2 + emb_rows
              + K * 2 * L * B * H * t_mean * Dh * 2
              + 2 * L * B * H * Mq * Dh * 2
              + K * 2 * L * B * H * Dh * 2 + K * B * 8)
        return fl, by
    return {
        "linear": lin,
        "encoder_attention": (4 * B * H * T * T * Dh,
                              3 * M * d * 2 + M * d * 2 + B * T * 4),
        "decode_chunk": chunk(V, K * B * d * 2),
        "decode_cont_chunk": chunk(N_mdn, 5 * d * 2),
    }


def ragged_work(rows, H, Dh):
    """(flops, bytes) of one ``ragged_attention`` call (bf16) on the packed
    rows ``rows``: the two products over each sketch's own n x n pairs
    (sum n^2, not B T^2), q, k and v read once, the output written once,
    and the work list."""
    M = int(rows.lengths.sum())
    pairs = int((rows.lengths.astype(np.int64) ** 2).sum())
    return (4 * H * pairs * Dh,
            4 * M * H * Dh * 2 + int(rows.work.shape[0]) * 12)


def token_kernel_work(M, d, V):
    """{kernel: (flops, bytes)} of K6 at the train shape: the CE
    forward (2 M d V); the backward's two kernels each recompute the logits
    from their inputs and do one product, 4 M d V each (the TPU kernel's
    one recompute serves both products: 6 M d V in all, of which dW's
    share is its 2 M d V product)."""
    x, wb = M * d * 2, d * V * 2 + V * 4
    return {
        "token_ce_fwd": (2 * M * d * V, x + wb + M * 4 + 3 * M * 4),
        "token_ce_dx": (4 * M * d * V, x + wb + 3 * M * 4 + M * d * 2),
        "token_ce_dw": (4 * M * d * V, x + wb + 3 * M * 4 + d * V * 4
                        + V * 4),
    }


def flash_work(B, T, H, Dh):
    """{kernel: (flops, bytes)} of K8 at (B, T, H, Dh), bf16, key mask: the
    forward's two products (4 B H T^2 Dh); the backward as the TPU kernel
    does it in one pass, the scores' recompute and four products (10 B H
    T^2 Dh); bytes: each input read once (q, k, v, the (B, T) f32 bias, and
    the output gradient) and each output written once."""
    x = B * T * H * Dh * 2
    return {"flash_attention_fwd": (4 * B * H * T * T * Dh,
                                    4 * x + B * T * 4),
            "flash_attention_bwd": (10 * B * H * T * T * Dh,
                                    7 * x + B * T * 4)}


def step_work(B, L, d, dff, t, Mq):
    """(flops, bytes) of one whole decode step at position t (bf16): the
    trunk's six products per layer and the attention over t cache rows,
    the new one and Mq cross rows; bytes: the trunk's weights, the cache
    rows [0, t), the cross K/V, the input, the output and the new rows."""
    prod = 6 * d * d + 2 * d * dff
    flops = B * L * (2 * prod + 4 * (t + 1 + Mq) * d)
    nbytes = (L * prod * 2 + 2 * L * B * (t + Mq) * d * 2 + 2 * B * d * 2
              + 2 * L * B * d * 2)
    return flops, nbytes


def attention_fwd_spread(o, B, T, d, H, qk, gpu):
    """``attention_fwd`` (bf16, norm_p, key mask) on ``train_operands``
    ``o``: the median and spread of SPREAD_CALLS calls' device time of the
    kernel, the plain version and SDPA with the same boolean mask (which
    has no qk-norm). Returns the three medians."""
    import torch.nn.functional as F

    q4, k4, v4 = (t.reshape(B, T, H, d // H).transpose(1, 2)
                  for t in (o["q"], o["k"], o["v"]))
    mask = (o["bias"] == 0)[:, None, None, :]
    sp = spread_ms(attn_calls(o, H, qk, "fwd", "kernel"),
                   attn_calls(o, H, qk, "fwd", "plain"),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          attn_mask=mask))
    print(f"time attention_fwd (bf16, B={B}, T={T}, H={H}, Dh={d // H}, "
          f"{'qk-norm, ' if qk else ''}key mask, device time, median of "
          f"{SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, plain "
          f"{fmt_spread(sp['plain'])}, library (SDPA, the same boolean mask) "
          f"{fmt_spread(sp['lib'])} [{gpu}]")
    return sp["kernel"][0], sp["plain"][0], sp["lib"][0]


def attention_bwd_spread(o, B, T, d, H, qk, gpu):
    """The attention backward (bf16, both passes on the tensor cores, key
    mask, dO in bf16 as the stacks pass it) on ``train_operands`` ``o``:
    the median and spread of SPREAD_CALLS calls' device time of each pass,
    of the pair, of their plain versions and of one SDPA backward with the
    same boolean mask (dq, dk and dv in one call; no qk-norm), beside the
    pair's bound. Returns {pass: (ms, plain ms, library ms)}; each pass's
    library time is the whole SDPA backward."""
    import torch
    import torch.nn.functional as F

    dt = torch.bfloat16
    o = dict(o, do=o["do"].to(dt))
    q4, k4, v4 = (t.reshape(B, T, H, d // H).transpose(1, 2).detach()
                  .requires_grad_(True) for t in (o["q"], o["k"], o["v"]))
    mask = (o["bias"] == 0)[:, None, None, :]
    with torch.enable_grad():
        sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    do4 = o["do"].reshape(B, T, H, d // H).transpose(1, 2)

    def lib_bwd():
        with torch.enable_grad():
            torch.autograd.grad(sdpa, (q4, k4, v4), do4, retain_graph=True)

    calls = {w: (attn_calls(o, H, qk, w, "kernel"),
                 attn_calls(o, H, qk, w, "plain"))
             for w in ("bwd_q", "bwd_kv")}

    def pair(mod):
        def run():
            calls["bwd_q"][mod]()
            calls["bwd_kv"][mod]()
        return run

    shape = (f"bf16, B={B}, T={T}, H={H}, Dh={d // H}, "
             f"{'qk-norm, ' if qk else ''}key mask, bf16 dO")
    out = {}
    with torch.no_grad():
        for w, name in (("bwd_q", "attention_bwd_q"),
                        ("bwd_kv", "attention_bwd_kv")):
            sp = spread_ms(calls[w][0], calls[w][1], None)
            out[name] = [sp["kernel"][0], sp["plain"][0]]
            print(f"time {name} ({shape}, device time, median of "
                  f"{SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, "
                  f"plain {fmt_spread(sp['plain'])} [{gpu}]")
        sp = spread_ms(pair(0), pair(1), lib_bwd)
    work = train_kernel_work(B, T, d, H, MDN["dff"])
    b_ms = sum(bound(*work[k])[0] for k in out)
    print(f"time attention backward pair ({shape}, device time, median of "
          f"{SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, plain "
          f"{fmt_spread(sp['plain'])}, library (one SDPA backward, dq dk dv, "
          f"the same boolean mask, no qk-norm) {fmt_spread(sp['lib'])}; "
          f"bound of the pair {b_ms:.4f} ms; kernel / library "
          f"{sp['kernel'][0] / sp['lib'][0]:.2f} [{gpu}]")
    return {k: (v[0], v[1], sp["lib"][0]) for k, v in out.items()}


def encoder_attention_spread(dev, B, T, H, Dh, qk, gpu, randn):
    """``encoder_attention`` (bf16, key mask with a fully masked row) over a
    fused (B, T, 3 H Dh) pane: the median and spread of SPREAD_CALLS calls'
    device time of the kernel (the tensor-core route), the plain version,
    this module's FMA kernel at the same call (the bf16 route before it
    moved, still built for the widths the tensor-core kernel does not take)
    and SDPA with the same boolean mask (no qk-norm). Returns (kernel,
    plain, library) medians."""
    import torch
    import torch.nn.functional as F

    from sketchformer_tpu_torch.ops import _build
    from sketchformer_tpu_torch.ops import encoder_stack as es

    dt, HD = torch.bfloat16, H * Dh
    qkv = randn(B, T, 3 * HD, dtype=dt)
    lengths = torch.randint(1, T + 1, (B,), device=dev)
    lengths[0] = 0
    kbias = torch.where(torch.arange(T, device=dev)[None] < lengths[:, None],
                        0.0, es.NEG_INF).float()
    norms = tuple(1.0 + randn(Dh, scale=0.1) if i % 2 == 0 else
                  randn(Dh, scale=0.1) for i in range(4)) if qk else None
    q4, k4, v4 = (t.reshape(B, T, H, Dh).transpose(1, 2)
                  for t in qkv.split(HD, dim=-1))
    amask = (kbias == 0)[:, None, None, :]
    fma_out = torch.empty((B, T, HD), dtype=dt, device=dev)
    ptrs = [_build.ptr(p) for p in (norms or (None,) * 4)]

    def fma():
        err = _build.library().sk_encoder_attention(
            1, _build.ptr(qkv), _build.ptr(kbias), *ptrs,
            _build.ptr(fma_out), B, T, H, Dh, 1.0 / Dh ** 0.5,
            _build.stream(qkv))
        _build.check(err, "encoder_attention (FMA)")

    kw = dict(num_heads=H, qk_norm=norms)
    with torch.inference_mode():
        want = es.attention_reference(qkv, kbias, **kw)
        fma()
        torch.cuda.synchronize()
        rel = (fma_out.float() - want.float()).abs().max().item() / \
            want.float().abs().max().item()
        if not rel <= TOL["bfloat16"]:
            fail(f"encoder_attention FMA kernel rel err {rel:.3e}")
        sp = spread_ms(lambda: es.encoder_attention(qkv, kbias, **kw),
                       lambda: es.attention_reference(qkv, kbias, **kw),
                       lambda: F.scaled_dot_product_attention(
                           q4, k4, v4, attn_mask=amask))
        old = spread_ms(fma, None, None)["kernel"]
    # the two products; q, k, v read once, the output written once
    b_ms, b_by = bound(4 * B * H * T * T * Dh, 4 * B * T * HD * 2 + B * T * 4)
    print(f"time encoder_attention (bf16, B={B}, T={T}, H={H}, Dh={Dh}"
          f"{', qk-norm' if qk else ''}, key mask, device time, median of "
          f"{SPREAD_CALLS}): kernel (mma.sync) {fmt_spread(sp['kernel'])}, "
          f"the FMA kernel it replaced {fmt_spread(old)}, plain "
          f"{fmt_spread(sp['plain'])}, library (SDPA, the same boolean mask) "
          f"{fmt_spread(sp['lib'])}; bound {b_ms:.4f} ms ({b_by}) [{gpu}]")
    return sp["kernel"][0], sp["plain"][0], sp["lib"][0]


def packed_embed_times(dev, gpu):
    """The embed cell's batch (B=2048, T=192, lengths 16-191 then EOS and
    PAD; tok_h8's heads): ``ragged_attention`` on its valid rows against
    the padded ``encoder_attention`` (one layer's call, without and with
    qk-norm); without qk-norm the persistent walk beside the 64-row query
    blocks' grid ("tiles"), which qk-norm takes; device time, median of
    SPREAD_CALLS calls. Every ragged route's rows must equal the padded
    kernel's (torch.equal)."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack as es

    B, T, H, Dh = 2048, 192, SBIR["H"], SBIR["d"] // SBIR["H"]
    rng = np.random.default_rng(22)
    # the valid positions of sketches of 16-191 tokens and their EOS
    valid = np.arange(T)[None] <= rng.integers(16, T, B)[:, None]
    rows, _ = es.pack_rows(valid)
    rows = rows.to(dev)
    index = rows.index.long()
    M, keys = int(valid.sum()), valid.sum(1).astype(np.int64)
    gen = torch.Generator(device=dev).manual_seed(22)
    bias = torch.where(torch.from_numpy(valid).to(dev), 0.0,
                       es.NEG_INF).float()
    with torch.inference_mode():
        for qk in (False, True):
            qkv = torch.randn((B, T, 3 * H * Dh), generator=gen,
                              device=dev).to(torch.bfloat16)
            norms = tuple(1.0 + 0.1 * torch.randn(
                Dh, generator=gen, device=dev) if i % 2 == 0 else
                0.1 * torch.randn(Dh, generator=gen, device=dev)
                for i in range(4)) if qk else None
            packed = qkv.reshape(B * T, -1).index_select(0, index)
            kw = dict(num_heads=H, qk_norm=norms)
            route = es.ragged_route(T, Dh, qk)[0]

            def ragged(route):
                return lambda: es.ragged_attention_on(route, packed, rows,
                                                      **kw)

            def padded():
                return es.encoder_attention(qkv, bias, **kw)

            want = padded().reshape(B * T, -1).index_select(0, index)
            for r in {route, "tiles"}:
                got = ragged(r)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"ragged_attention {r} (qk-norm {qk}) differs from "
                         f"the padded kernel on valid rows")
            sp = spread_ms(ragged(route), padded, None)
            beside = ""
            if route != "tiles":
                tiles = spread_ms(ragged("tiles"), None, None)["kernel"]
                beside = (f", the 64-row query blocks' grid (\"tiles\") "
                          f"{fmt_spread(tiles)}")
            b_ms, b_by = bound(4 * H * Dh * int((keys ** 2).sum()),
                               4 * M * H * Dh * 2)
            print(f"time ragged_attention (bf16, B={B}, T={T}, H={H}, "
                  f"Dh={Dh}{', qk-norm' if qk else ''}, {M} valid rows of "
                  f"{B * T}; device time, median of {SPREAD_CALLS}): "
                  f"{route} {fmt_spread(sp['kernel'])}{beside}, padded "
                  f"encoder_attention {fmt_spread(sp['plain'])}; bound "
                  f"{b_ms:.4f} ms ({b_by}) [{gpu}]")


def linear_nt_spread(o, B, T, d, dff, gpu):
    """One encoder layer's four ``linear_nt`` calls (bf16) on
    ``train_operands`` ``o``: the median and spread of SPREAD_CALLS calls'
    device time of the kernel, the plain version and the layer's four
    matmuls. Returns the three medians."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack as es

    def lib_nt():
        for a, w in ((o["g"], o["w2"]), (o["gf"], o["w1"]),
                     (o["g32"], o["wo"]), (o["gqkv"], o["wqkv"])):
            torch.matmul(a.to(w.dtype), w.t())

    sp = spread_ms(layer_nt_calls(o, es.linear_nt),
                   layer_nt_calls(o, es.linear_nt_reference), lib_nt)
    print(f"time linear_nt (bf16, B={B}, T={T}, M={B * T}, d={d}, "
          f"dff={dff}, the layer: 4 calls, device time, median of "
          f"{SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, plain "
          f"{fmt_spread(sp['plain'])}, library (4 matmuls) "
          f"{fmt_spread(sp['lib'])} [{gpu}]")
    # each call alone: which of the four the layer's time goes to
    ks = dict(drop=o["drop"], thresh=o["thresh"], keep_scale=o["ks"])
    for label, a, w, kw in (
            ("dY.W2^T, bf16 dY, 'bits' mask, ReLU gate, N 256 K 512",
             o["g"], o["w2"], dict(gate=o["f1"], **ks)),
            ("dF.W1^T, f32 dF, N 512 K 256", o["gf"], o["w1"], {}),
            ("dX1.Wo^T, f32, 'bits' mask, N 256 K 256", o["g32"], o["wo"],
             ks),
            ("dQKV.Wqkv^T, f32, N 768 K 256", o["gqkv"], o["wqkv"], {})):
        one = spread_ms(lambda: es.linear_nt(a, w, **kw), None,
                        lambda: torch.matmul(a.to(w.dtype), w.t()))
        print(f"time linear_nt call {label} (M={B * T}, device time, median "
              f"of {SPREAD_CALLS}): kernel {fmt_spread(one['kernel'])}, "
              f"library (cast + matmul) {fmt_spread(one['lib'])} [{gpu}]")
    return sp["kernel"][0], sp["plain"][0], sp["lib"][0]


def train_kernel_times(randn, dev, gpu, paired):
    """Each training kernel (the layer's call set) against its plain version
    and, where one PyTorch call computes the same function, that call; bf16
    at the cont2cont_mdn layer, and ``attention_fwd`` also at the
    cont_train geometry. Returns {kernel: (ms, plain_ms, lib_ms)} at the
    cont2cont_mdn layer."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack as es

    B, T, d, H, dff = (MDN[k] for k in ("B", "T", "d", "H", "dff"))
    dt = torch.bfloat16
    o = train_operands(randn, dev, B=B, T=T, d=d, H=H, dff=dff, dtype=dt,
                       qk=True)
    out = {}

    def lib_tn():
        for x, y in ((o["f1"], o["g"]), (o["x"], o["gf"]), (o["x"], o["g32"]),
                     (o["x"], o["gqkv"])):
            torch.matmul(x.t(), y.to(dt))

    with torch.no_grad():
        out["linear_nt"] = linear_nt_spread(o, B, T, d, dff, gpu)
        sp = spread_ms(layer_tn_calls(o, es.linear_tn),
                       layer_tn_calls(o, es.linear_tn_reference), lib_tn)
        out["linear_tn"] = (sp["kernel"][0], sp["plain"][0], sp["lib"][0])
        host = paired(layer_tn_calls(o, es.linear_tn),
                      layer_tn_calls(o, es.linear_tn_reference), iters=10,
                      warm=2)
        print(f"time linear_tn (bf16, B={B}, T={T}, d={d}, dff={dff}, the "
              f"layer: 4 calls with their bias gradients, device time, "
              f"median of {SPREAD_CALLS}): kernel "
              f"{fmt_spread(sp['kernel'])}, plain "
              f"{fmt_spread(sp['plain'])}, library (4 matmuls) "
              f"{fmt_spread(sp['lib'])}; back to back with the host's "
              f"launches: kernel {host[0]:.4f} ms, plain {host[1]:.4f} ms "
              f"[{gpu}]")
        out["attention_fwd"] = attention_fwd_spread(o, B, T, d, H, True,
                                                    gpu)
    out.update(attention_bwd_spread(o, B, T, d, H, True, gpu))
    # the same call without qk-norm: what the norms cost the pair
    attention_bwd_spread(o, B, T, d, H, False, gpu)
    del o
    # the train_h8 geometry (B=512, T=96, H=8/Dh=32, no qk-norm): the
    # attention backward and forward
    h8 = dict(CONT_TRAIN, H=8)
    o = train_operands(randn, dev, dtype=dt, qk=False,
                       **{k: h8[k] for k in ("B", "T", "d", "H", "dff")})
    attention_bwd_spread(o, h8["B"], h8["T"], h8["d"], 8, False, gpu)
    with torch.no_grad():
        attention_fwd_spread(o, h8["B"], h8["T"], h8["d"], 8, False, gpu)
    del o
    # the cont_train / train geometry (H=2/Dh=128, no qk-norm)
    ct = {k: CONT_TRAIN[k] for k in ("B", "T", "d", "H", "dff")}
    o = train_operands(randn, dev, dtype=dt, qk=False, **ct)
    attention_bwd_spread(o, ct["B"], ct["T"], ct["d"], ct["H"], False, gpu)
    with torch.no_grad():
        attention_fwd_spread(o, ct["B"], ct["T"], ct["d"], ct["H"], False, gpu)
        k_ms, _, l_ms = linear_nt_spread(o, ct["B"], ct["T"], ct["d"],
                                         ct["dff"], gpu)
        b_ms, b_by = bound(*train_kernel_work(**ct)["linear_nt"])
        print(f"bound linear_nt (bf16, B={ct['B']}, T={ct['T']}, the layer: "
              f"4 calls): {b_ms:.4f} ms ({b_by}); kernel / bound "
              f"{k_ms / b_ms:.2f}, kernel / library {k_ms / l_ms:.2f} "
              f"[{gpu}]")
    del o
    torch.cuda.empty_cache()
    return out


def norm_work(M, D, R, N):
    """(flops, bytes, 4) of the timed layernorm_bwd call (x and the
    residual bf16, dy and dx f32, M x D; scale read, dscale and dbias
    written, f32) and sum_rows call (R x N f32 rows to N f32 sums); their
    arithmetic is f32 outside the tensor cores."""
    return {"layernorm_bwd": (10 * M * D, M * D * (2 + 4 + 2 + 4) + 3 * D * 4,
                              4),
            "sum_rows": (R * N, R * N * 4 + N * 4, 4)}


def norm_times(randn, gpu):
    """``layernorm_bwd`` and ``sum_rows`` as the median and spread of
    SPREAD_CALLS calls' device time (``call_ms``: each call between its own
    events, queued behind a spin), beside their plain versions and one
    PyTorch call read the same way, and their bounds: ``layernorm_bwd`` at
    the stacks' dtypes (x and the residual bf16, dy and dx f32, D 256) at M
    12,288 (cont2cont_mdn) and 49,152 (B=512, T=96), against
    ``native_layer_norm_backward`` on the f32 rows; ``sum_rows`` on f32
    rows at (12,288, 768) and at the f32 attention backward's qk-norm
    partial rows, against ``torch.sum``. Each is first held to its plain
    version. Returns {name: (ms, plain_ms, lib_ms)} at M 12,288 and at the
    partial rows (the main paths' shapes)."""
    import torch

    from sketchformer_tpu_torch.ops import norm_train as nt

    d = MDN["d"]
    out = {}
    for M in (MDN["B"] * MDN["T"], CONT_TRAIN["B"] * CONT_TRAIN["T"]):
        x, g = randn(M, d, dtype=torch.bfloat16), randn(M, d)
        res = randn(M, d, dtype=torch.bfloat16)
        s, b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
        x32 = x.float()
        _, mean, rstd = torch.ops.aten.native_layer_norm(x32, [d], s, b, 1e-6)
        kern = lambda: nt.layernorm_bwd(x, g, s, resid=res)
        plain = lambda: nt.layernorm_bwd_reference(x, g, s, resid=res)
        for part, k, p in zip(("dx", "dscale", "dbias"), kern(), plain()):
            rel = (k - p).abs().max().item() / p.abs().max().item()
            if not rel <= TOL["float32"]:
                fail(f"layernorm_bwd M={M} {part}: rel err {rel:.3e}")
        with torch.no_grad():
            sp = spread_ms(kern, plain, lambda: torch.ops.aten.
                           native_layer_norm_backward(
                               g, x32, [d], mean, rstd, s, b,
                               [True, True, True]))
        b_ms, b_by = bound(*norm_work(M, d, 1, 1)["layernorm_bwd"])
        print(f"time layernorm_bwd (x and residual bf16, dy and dx f32, M={M}"
              f", D={d}; device time, median of {SPREAD_CALLS}): kernel "
              f"{fmt_spread(sp['kernel'])}, plain {fmt_spread(sp['plain'])}, "
              f"library (native_layer_norm_backward, f32) "
              f"{fmt_spread(sp['lib'])}; bound {b_ms:.4f} ms ({b_by}); "
              f"kernel / bound {sp['kernel'][0] / b_ms:.2f}, kernel / "
              f"library {sp['kernel'][0] / sp['lib'][0]:.2f} [{gpu}]")
        out.setdefault("layernorm_bwd", (sp["kernel"][0], sp["plain"][0],
                                         sp["lib"][0]))
        del x, g, res, x32
    for R, N in ((MDN["B"] * MDN["T"], 3 * d), K5_F32_PARTIALS):
        x = randn(R, N)
        rel = (nt.sum_rows(x) - nt.sum_rows_reference(x)).abs().max().item() \
            / nt.sum_rows_reference(x).abs().max().item()
        if not rel <= TOL["float32"]:
            fail(f"sum_rows ({R}, {N}): rel err {rel:.3e}")
        sp = spread_ms(lambda: nt.sum_rows(x),
                       lambda: nt.sum_rows_reference(x),
                       lambda: torch.sum(x, dim=0))
        b_ms, b_by = bound(*norm_work(1, 1, R, N)["sum_rows"])
        print(f"time sum_rows (f32 rows ({R}, {N}); device time, median of "
              f"{SPREAD_CALLS}): kernel {fmt_spread(sp['kernel'])}, plain "
              f"{fmt_spread(sp['plain'])}, library (sum) "
              f"{fmt_spread(sp['lib'])}; bound {b_ms:.4f} ms ({b_by}); "
              f"kernel / bound {sp['kernel'][0] / b_ms:.2f}, kernel / "
              f"library {sp['kernel'][0] / sp['lib'][0]:.2f} [{gpu}]")
        out["sum_rows"] = (sp["kernel"][0], sp["plain"][0], sp["lib"][0])
        del x
    torch.cuda.empty_cache()
    return out


# the optimizer step's micro-timing: tok_h8's parameter list (the token
# training cell's), gradients of norm ~4 (clipped)
OPT_CONFIG = os.path.join(REPO, "perfbench", "configs", "tok_h8.json")


def optimizer_times(dev, gpu):
    """The optimizer step (``schedule.global_norm`` + ``NoamAdam.step``: the
    norm, prepare and update kernels) at tok_h8's parameter list, held to
    the plain route from the same state on two steps: from count 0, where
    the bias corrections weigh most, and from count 5,000, past the warmup,
    where the rate is ~3,600 times count 0's. The parameters start at zero,
    so each is the sum of its changes, and an update's error shows against
    the update's size and not against the parameter's. Then the step as the
    median and spread of SPREAD_CALLS calls' device time (``call_ms``)
    beside the plain route on the same tensors (its ~1,500 launches
    outlast the spin that queues a call ahead, so its device time holds
    the host's gaps) and the bound: each gradient read twice (the norm, the
    update), p, mu and nu read and written once, 32 bytes an element.
    Returns (ms, plain_ms)."""
    import dataclasses

    import torch

    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.ops import optimizer as opt_ops
    from sketchformer_tpu_torch.train import schedule

    with open(OPT_CONFIG) as f:
        cfg = json.load(f)
    fields = {f.name for f in dataclasses.fields(SketchformerConfig)}
    shapes = [p.shape for p in Sketchformer(SketchformerConfig(
        **{k: v for k, v in cfg.items() if k in fields})).parameters()]
    gen = torch.Generator(device=dev).manual_seed(21)
    params = [torch.zeros(s, device=dev) for s in shapes]
    grads = [1e-3 * torch.randn(s, generator=gen, device=dev)
             for s in shapes]
    opt = schedule.make_optimizer(params, cfg["d_model"])
    twin = [[t.clone() for t in ts] for ts in (params, opt.mu, opt.nu)]
    count = torch.zeros((), dtype=torch.int64, device=dev)

    def kern():
        opt.step(grads, schedule.global_norm(grads))

    def plain():
        tp, tm, tv = twin
        opt_ops.adam_update_reference(
            tp, grads, tm, tv, opt_ops.global_norm_reference(grads), count,
            **opt.hyper())

    for at in (0, 5000):
        opt.count = at
        count.fill_(at)
        opt_ops.reset_launches()
        kern()
        launches = sum(opt_ops.LAUNCHES.values())
        plain()
        for name, got, want in zip(("params", "mu", "nu"),
                                   (params, opt.mu, opt.nu), twin):
            err = max(((a - b).abs().max()
                       / b.abs().max().clamp_min(1e-30)).item()
                      for a, b in zip(got, want))
            if not err <= 1e-6:
                fail(f"optimizer step from count {at}: {name} rel err "
                     f"{err:.3e}")
    sp = spread_ms(kern, plain, None)
    elements = sum(int(np.prod(s)) for s in shapes)
    b_ms, b_by = bound(15 * elements, 32 * elements, 4)
    print(f"time optimizer step (global_norm + NoamAdam.step, tok_h8: "
          f"{len(shapes)} tensors, {elements} elements, {launches} launches;"
          f" device time, median of {SPREAD_CALLS}): kernels "
          f"{fmt_spread(sp['kernel'])}, plain route "
          f"{fmt_spread(sp['plain'])}; bound {b_ms:.4f} ms ({b_by}); "
          f"kernels / bound {sp['kernel'][0] / b_ms:.2f}, plain / kernels "
          f"{sp['plain'][0] / sp['kernel'][0]:.1f} [{gpu}]")
    del params, grads, opt, twin
    torch.cuda.empty_cache()
    return sp["kernel"][0], sp["plain"][0]


# the main-path shapes of the kernels redesigned under rule 2's second
# part: layernorm_rows (bf16, D=256) at the sbir / cont2cont_mdn rows
# (B=64 x T=192) and the train rows (B=512 x T=96); K12 at the composed
# decode's B*H = 512, Dh = 32, Tmax = 192 midway and at the last step of a
# decode; K7's emit at one composed site of pretrain_full (the stacks'
# entry dropout of its largest bucket, (B, T, d) = (256, 192, 256))
LN_ROWS_M = (MDN["B"] * MDN["T"], CONT_TRAIN["B"] * CONT_TRAIN["T"])
K12_LENS = (AR["T"] // 2, AR["T"] - 1)
EMIT_SITE = (256, 192, 256)
# K7's emit checks: ((B, T, d) of one site, route): the pretrain_full
# site, a post-LN FFN site and a row of 70 bytes (not whole 16-byte runs)
EMIT_CHECKS = ((EMIT_SITE, "vec16"), ((64, 192, 512), "vec16"),
               ((3, 7, 10), "bytes"))


def rule2_work(name, *shape):
    """(flops, bytes) of one call: layernorm_rows (M, D) in bf16 (x read,
    y written, f32 scale and bias); decode_attention (B*H, Dh, cache_len)
    in bf16 (q, the filled k and v rows, the output); decode_step (B, t)
    at the ar_decode width (``step_work``); the emit of (B, T, d)
    bytes."""
    if name == "layernorm_rows":
        M, D = shape
        return 8 * M * D, 2 * M * D * 2 + 2 * D * 4
    if name == "decode_attention":
        BH, Dh, n = shape
        return 4 * BH * n * Dh, (2 * BH * Dh + 2 * BH * n * Dh) * 2
    if name == "decode_step":
        B, t = shape
        return step_work(B=B, L=AR["L"], d=AR["d"], dff=AR["dff"], t=t,
                         Mq=AR["Mq"])
    B, T, d = shape
    return 0, B * T * d



def rule2_cases(randn):
    """The calls of ``layernorm_rows``, K12 ``decode_attention``, K13
    ``decode_step`` and K7's emit at their main-path shapes, as (name,
    shape, what, kernel, plain, library or None, the library call's name,
    calls): bf16 rows with ``F.layer_norm`` (its parameters in bf16) beside
    them; K12 with SDPA on the filled slice ``k[:, :len]``; K13 (bf16, B=64,
    t=96, the ar_decode width) and the emit with no library call, the emit
    also at the (2L, B, T, d) = (16, 512, 96, 256) tensor of a whole 'bits'
    stack, on no main path (20 calls: its plain version takes 47 ms). The
    calls reach each module through its wrapper alone, so the cases run on
    the parent commit's package too."""
    import torch
    import torch.nn.functional as F

    from sketchformer_tpu_torch.ops import decode_attention as da
    from sketchformer_tpu_torch.ops import decode_step as dstep
    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack as es

    dt, dev, d, cases = torch.bfloat16, torch.device("cuda"), MDN["d"], []
    for M in LN_ROWS_M:
        x = randn(M, d, dtype=dt)
        s, b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
        sd, bd = s.to(dt), b.to(dt)
        cases.append((
            "layernorm_rows", (M, d), f"bf16, M={M}, D={d}",
            lambda x=x, s=s, b=b: es.layernorm_rows(x, s, b),
            lambda x=x, s=s, b=b: es.layernorm_rows_reference(x, s, b),
            lambda x=x, sd=sd, bd=bd: F.layer_norm(x, (d,), sd, bd, 1e-6),
            "layer_norm", SPREAD_CALLS))
    BH, Dh, T = AR["H"] * 64, AR["d"] // AR["H"], AR["T"]
    q = randn(BH, 1, Dh, dtype=dt)
    k, v = (randn(BH, T, Dh, dtype=dt) for _ in range(2))
    for n in K12_LENS:
        cases.append((
            "decode_attention", (BH, Dh, n),
            f"bf16, B*H={BH}, Dh={Dh}, Tmax={T}, cache_len={n}",
            lambda n=n: da.decode_attention(q, k, v, n),
            lambda n=n: da.decode_attention_reference(q, k, v, n),
            lambda n=n: F.scaled_dot_product_attention(q, k[:, :n],
                                                       v[:, :n]),
            "SDPA on the filled slice", SPREAD_CALLS))
    t = AR["T"] // 2
    o = step_operands(randn, torch.Generator(device=dev).manual_seed(13),
                      dev, dt, AR["H"], False, t)
    sargs = (o["x"], o["k_cache"], o["v_cache"], o["cross_k"],
             o["cross_v"], o["w"], t)
    cases.append((
        "decode_step", (64, t),
        f"bf16, B=64, L={AR['L']}, d={AR['d']}, H={AR['H']}, Tmax={T}, t={t}",
        lambda: dstep.fused_decode_step(*sargs, num_heads=AR["H"]),
        lambda: dstep.fused_decode_step_reference(*sargs,
                                                  num_heads=AR["H"]),
        None, None, SPREAD_CALLS))
    L, Bt, Tt = TRAIN["L"], TRAIN["B"], TRAIN["T"]
    for shape, args, calls, where in (
            (EMIT_SITE, (1, 1, *EMIT_SITE), SPREAD_CALLS,
             "one pretrain_full site"),
            ((2 * L * Bt, Tt, d), (L, 2, Bt, Tt, d), 20,
             "a whole 'bits' stack's (2L, B, T, d), on no main path")):
        cases.append((
            "emit_dropout_bits", shape, f"{shape} u8, {where}",
            lambda args=args: dp.emit_dropout_bits(PRNG_SEED, *args, dev),
            lambda args=args: dp.emit_dropout_bits_reference(PRNG_SEED,
                                                             *args, dev),
            None, None, calls))
    return cases


def rule2_spreads(cases, gpu):
    """Each of :func:`rule2_cases` as the median and spread of its calls'
    device time (``call_ms``, in turns with its plain version and library
    call), beside its bound; first the launch floor, what ``call_ms`` reads
    for the least work the card can be given. Returns {(name, shape):
    (kernel, plain, library) spreads}."""
    import torch

    tiny = torch.zeros(16, device=torch.device("cuda"))
    floor = call_ms(tiny.zero_, SPREAD_CALLS)
    print(f"time launch floor (call_ms of zero_ on 16 floats; median of "
          f"{SPREAD_CALLS}): {float(np.median(floor)):.4f} ms (min "
          f"{min(floor):.4f}, max {max(floor):.4f}) [{gpu}]")
    out = {}
    with torch.no_grad():
        for name, shape, what, kern, plain, lib_fn, lib_name, calls in cases:
            sp = spread_ms(kern, plain, lib_fn, n=calls)
            b_ms, b_by = bound(*rule2_work(name, *shape))
            k = sp["kernel"][0]
            lib = "" if sp["lib"] is None else (
                f", library ({lib_name}) {fmt_spread(sp['lib'])}; kernel /"
                f" library {k / sp['lib'][0]:.2f}")
            print(f"time {name} ({what}; device time, median of {calls}): "
                  f"kernel {fmt_spread(sp['kernel'])}, plain "
                  f"{fmt_spread(sp['plain'])}; bound {b_ms:.5f} ms "
                  f"({b_by}); bound / kernel {b_ms / k:.2f}{lib} [{gpu}]")
            out[(name, shape)] = sp
    return out


# the device events of a kernel whose name is not its wrapper's: K13 runs
# the cluster kernel's step kind in bf16 (the per-row decode_step_kernel
# before)
EVENT_NAMES = {"decode_step": ("decode_cluster_kernel", "decode_step_kernel")}


def rule2_kernel_events(cases, gpu):
    """Each kernel of :func:`rule2_cases` alone: its launches' durations in
    a ``device_trace`` of its calls (after one warm call), which hold none
    of the launch floor. It reads the median of the events the trace kept
    and says how many; fewer than TRACE_KEPT_SHARE is not read (the
    call_ms readings are the measurement)."""
    import torch

    with torch.no_grad():
        for name, shape, what, kern, _, _, _, calls in cases:
            kern()
            torch.cuda.synchronize()
            with device_trace() as prof:
                for _ in range(calls):
                    kern()
            keys = EVENT_NAMES.get(name, (name,))
            ev = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and any(k in e.name for k in keys)]
            got = (f"{fmt_spread((float(np.median(ev)), min(ev), max(ev)))}"
                   if calls * TRACE_KEPT_SHARE <= len(ev) <= calls
                   else "not read")
            print(f"time {name} ({what}; the kernel's events in a profiler "
                  f"trace, median of the {len(ev)} of {calls} launches it "
                  f"kept): {got} [{gpu}]")


def start_sass_dump(lib_path):
    """(process, output path) of ``cuobjdump -sass`` of the built library,
    started now so that its tens of seconds overlap the checks; None where
    the toolkit has no cuobjdump. The process is killed at exit if it is
    still running."""
    import atexit

    from sketchformer_tpu_torch.ops import _build

    cuobj = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobj):
        return None
    fd, path = tempfile.mkstemp(suffix=".sass")
    with os.fdopen(fd, "w") as f:
        proc = subprocess.Popen([cuobj, "-sass", lib_path], stdout=f,
                                stderr=subprocess.DEVNULL)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def emit_sass_floors(sass, gpu):
    """K7's emit beside its instruction count: the opcodes of
    ``emit_dropout_bits_kernel`` in the built library's SASS (``sass``,
    :func:`start_sass_dump`'s dump), the Philox part of a call (its wide
    multiplies and three-way XORs, a quarter of the kernel's: four calls an
    item, unrolled) and two floors for EMIT_SITE's calls at the card's
    highest SM clock (nvidia-smi) on 132 SMs: the dispatch floor, that part
    at one warp instruction a clock for each of an SM's four schedulers,
    and the multiply floor, each wide multiply two 32-bit multiplies (its
    low and high halves) at the 64 a clock an SM that NVIDIA's throughput
    table gives compute capability 9.0 for 32-bit integer multiplies."""
    import collections

    if sass is None:
        print("emit SASS: not measured (no cuobjdump in the toolkit)")
        return
    proc, path = sass
    if proc.wait() != 0:
        fail(f"cuobjdump -sass returned {proc.returncode}")
    with open(path) as f:
        out = f.read()
    os.unlink(path)
    body = [p for p in re.split(r"\n\s*Function : ", out)
            if "emit_dropout_bits_kernel" in p.split("\n", 1)[0]]
    if len(body) != 1:
        fail(f"emit SASS: {len(body)} emit kernels in the library")
    ops = [".".join(m.split(".")[:2]) if m.startswith("IMAD.")
           else m.split(".")[0]
           for m in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                               r"([A-Z][A-Z0-9_.]*)", body[0])]
    count = collections.Counter(ops)
    # a call's multiplies (one wide, or a low and a high half) and XORs:
    # a quarter of the kernel's, the prologue's few included
    per_call = sum(n for op, n in count.items()
                   if op in ("IMAD", "IMAD.WIDE", "IMAD.HI", "LOP3")) / 4
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    calls = EMIT_SITE[0] * EMIT_SITE[1] * EMIT_SITE[2] / 4
    floor_ms = calls * per_call / (4 * 32 * 132 * mhz * 1e6) * 1e3
    muls = (2 * count["IMAD.WIDE"] + count["IMAD"] + count["IMAD.HI"]) / 4
    mul_ms = calls * muls / (64 * 132 * mhz * 1e6) * 1e3
    print(f"emit SASS: {len(ops)} instructions, "
          f"{json.dumps(dict(count.most_common(12)))}; a Philox call "
          f"{per_call:.1f} multiplies and three-way XORs, {muls:.1f} 32-bit "
          f"multiplies; at {EMIT_SITE} ({calls:.0f} calls, {mhz:.0f} MHz): "
          f"dispatch floor {floor_ms:.5f} ms, multiply floor {mul_ms:.5f} ms "
          f"[{gpu}]")


def stack_work(B, T, d, H, dff, L, decoder):
    """(flops, bytes) of a train stack's forward + backward as the TPU
    kernels do it: the forward, its recompute in the backward and the two
    backward products of every product and attention (4x the forward's
    operations); bytes: each layer's input and output activations, the
    weights and their f32 gradients, the input gradient (bf16)."""
    M = B * T
    proj = d * (3 * d + d + 2 * dff) + (2 * d * d if decoder else 0)
    fwd = 2 * M * proj + 4 * B * H * T * T * (d // H)
    if decoder:
        fwd += 4 * B * H * T * 4 * (d // H) + 2 * B * 4 * d * 2 * d
    w = L * (proj + (2 * d * d if decoder else 0))
    return 4 * L * fwd, L * 4 * M * d * 2 + w * (2 + 4)


def stack_times(dev, gpu, cuda_ms):
    """Encoder and decoder train stacks, forward + backward (L=8, dropout
    0.1, bf16, cont2cont_mdn width), kernels against the plain versions,
    beside the bound of :func:`stack_work`."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack_train as est

    B, T, d, H = (MDN[k] for k in ("B", "T", "d", "H"))
    gen = torch.Generator(device=dev).manual_seed(4)
    for decoder in (False, True):
        mod = stack_module(dev, decoder, H, True, torch.bfloat16,
                           L=MDN["L"])
        x = torch.randn((B, T, d), generator=gen, device=dev)
        mem = torch.randn((B, 4, d), generator=gen, device=dev)
        gy = torch.randn((B, T, d), generator=gen, device=dev)
        km = torch.ones((B, T), dtype=torch.bool, device=dev)
        drop = torch.randint(0, 256, ((3 if decoder else 2) * MDN["L"], B, T,
                                      d), dtype=torch.uint8, generator=gen,
                             device=dev)
        args = (mod, x, mem, km, gy, drop, decoder, H, True)
        ms = {}
        for label, ops in (("kernel", est.KERNELS), ("plain", est.PLAIN)):
            ms[label] = cuda_ms(lambda: stack_grads(*args, ops,
                                                    torch.bfloat16), 3, 1)
        b_ms, b_by = bound(*stack_work(B, T, d, H, MDN["dff"], MDN["L"],
                                       decoder))
        print(f"time fused_{'decoder' if decoder else 'encoder'}_stack_train "
              f"fwd+bwd (L={MDN['L']}, B={B}, T={T}, d={d}, H={H}, qk_norm, "
              f"bf16, dropout 0.1, bits mode): kernel {ms['kernel']:.2f} ms, "
              f"plain {ms['plain']:.2f} ms, bound {b_ms:.4f} ms "
              f"({b_by}) [{gpu}]")
        del mod


def rule2_only(argv) -> int:
    """``python3 chip_smoke.py --rule2 ROOT LABEL``: build the package under
    ROOT (this checkout, or an unpacked ``git archive`` of another commit,
    so that a parent is timed in the same chip call) and print the rule-2
    kernels' timings (``rule2_spreads``, ``rule2_kernel_events``) under
    LABEL. No check runs and no result line is printed."""
    import torch

    if len(argv) != 3 or argv[0] != "--rule2":
        print("usage: chip_smoke.py [--rule2 ROOT LABEL]", file=sys.stderr)
        return 2
    root, label = os.path.abspath(argv[1]), argv[2]
    # this script's helpers came from this checkout's package; the package
    # timed is the one under ROOT
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "sketchformer_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    import sketchformer_tpu_torch
    from sketchformer_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(sketchformer_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        fail(f"--rule2: imported {pkg}, not the package under {root}")
    info = _build.build()
    _build.library()
    gpu = gpu_line()
    print(f"=== {label}: {pkg}, build {info['seconds']:.1f} s [{gpu}]")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cases = rule2_cases(randn_from(torch.Generator(device=dev).manual_seed(0),
                                   dev))
    rule2_spreads(cases, gpu)
    rule2_kernel_events(cases, gpu)
    print(f"=== {label} done")
    return 0


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        return rule2_only(sys.argv[1:])
    sys.path.insert(0, REPO)
    from sketchformer_tpu_torch import cli, ops
    from sketchformer_tpu_torch.infer import decode as dec
    from sketchformer_tpu_torch.infer.fast_decode import decoder_operands
    from sketchformer_tpu_torch.infer.fast_encode import (
        fast_embed,
        packed_rows,
    )
    from sketchformer_tpu_torch.ops import _build
    from sketchformer_tpu_torch.ops import decode_attention as da
    from sketchformer_tpu_torch.ops import decode_chunk as dc
    from sketchformer_tpu_torch.ops import encoder_stack as es
    from sketchformer_tpu_torch.infer.fast_decode import (
        make_step_token_decoder,
    )
    from sketchformer_tpu_torch.ops import decode_step as dstep
    from sketchformer_tpu_torch.ops import flash_attention as fa
    from sketchformer_tpu_torch.utils import engines

    counters = ops.counted_modules()

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc_version(_build._nvcc())} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 2. build ----------------------------------------------------------
    info = _build.build(force=True)
    sass = start_sass_dump(info["path"])
    print(f"build: {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()

    # ---- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = randn_from(gen, dev)

    def ln_params(n):
        return (1.0 + randn(n, scale=0.1), randn(n, scale=0.1))

    def key_mask(B, T):
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        lengths[0] = 0                 # one fully masked row
        lengths[1] = T                 # one row with no padding
        return torch.arange(T, device=dev)[None, :] < lengths[:, None]

    def stack_weights(L, d, H, dff, dtype):
        Dh = d // H
        w = {"wqkv": randn(L, d, 3 * d, scale=d ** -0.5, dtype=dtype),
             "bqkv": randn(L, 3 * d, scale=0.1),
             "wo": randn(L, d, d, scale=d ** -0.5, dtype=dtype),
             "bo": randn(L, d, scale=0.1),
             "w1": randn(L, d, dff, scale=d ** -0.5, dtype=dtype),
             "b1": randn(L, dff, scale=0.1),
             "w2": randn(L, dff, d, scale=dff ** -0.5, dtype=dtype),
             "b2": randn(L, d, scale=0.1),
             "lnfs": 1.0 + randn(1, d, scale=0.1), "lnfb": randn(1, d, scale=0.1)}
        for s, b, n in (("ln1s", "ln1b", d), ("ln2s", "ln2b", d),
                        ("qns", "qnb", Dh), ("kns", "knb", Dh)):
            w[s] = 1.0 + randn(L, n, scale=0.1)
            w[b] = randn(L, n, scale=0.1)
        return w

    errs = {k: 0.0 for k in REPLACES}   # bf16, main-path shapes (B=64)

    def compare(name, got, ref, dtype, record=None, scale=None):
        """max |got - ref| <= TOL * max |ref| (or * ``scale`` for an output
        that is zero up to rounding)."""
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            fail(f"{name}: kernel output not finite")
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item() if scale is None else scale,
                        1e-30)
        tol = TOL[str(dtype).replace("torch.", "")]
        print(f"check {name}: max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {tol:.0e})")
        if not rel <= tol:
            fail(f"{name}: rel err {rel:.3e} above {tol:.0e}")
        if record is not None:
            errs[record] = max(errs[record], err)

    T, d, H, dff, L = (SBIR[k] for k in ("T", "d", "H", "dff", "L"))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        main_rec = dtype == torch.bfloat16
        B = 64
        M = B * T
        x = randn(M, d, dtype=dtype)
        hid = torch.relu(randn(M, dff, dtype=dtype))
        for what, a, K, N, kw in (
                ("qkv", x, d, 3 * d, {}),
                ("out+res", x, d, d, dict(residual=randn(M, d, dtype=dtype))),
                ("ffn_in", x, d, dff, dict(relu=True)),
                ("ffn_out+res", hid, dff, d,
                 dict(residual=randn(M, d, dtype=dtype))),
                ("ragged", randn(1000, 100, dtype=dtype), 100, 70,
                 dict(relu=True, residual=randn(1000, 70, dtype=dtype)))):
            w = randn(K, N, scale=K ** -0.5, dtype=dtype)
            b = randn(N, scale=0.1)
            compare(f"linear {tag} {what} M={a.shape[0]} K={K} N={N}",
                    es.linear(a, w, b, **kw),
                    es.linear_reference(a, w, b, **kw), dtype,
                    "linear" if main_rec and what != "ragged" else None)
        for (Bq, Tq, Hq, Dh, qk) in ((64, T, H, 32, False),
                                     (64, T, H, 32, True),
                                     (64, T, 2, 128, False),
                                     (64, T, 2, 128, True),
                                     (8, 50, 4, 64, True),
                                     (2, 1024, 2, 128, True)):
            qkv = randn(Bq, Tq, 3 * Hq * Dh, dtype=dtype)
            km = key_mask(Bq, Tq)
            kbias = torch.where(km, 0.0, es.NEG_INF).float()
            norms = tuple(p for _ in range(2) for p in ln_params(Dh)) if qk else None
            compare(f"encoder_attention {tag} B={Bq} T={Tq} H={Hq} Dh={Dh} "
                    f"qk_norm={qk}",
                    es.encoder_attention(qkv, kbias, num_heads=Hq,
                                         qk_norm=norms),
                    es.attention_reference(qkv, kbias, num_heads=Hq,
                                           qk_norm=norms), dtype,
                    "encoder_attention" if main_rec and Hq == H else None)
        for rows, D, off, route32, route16 in LN_ROWS_CHECKS:
            xr = x if (rows, D, off) == (M, d, 0) else randn(
                rows * D + off, dtype=dtype)[off:].view(rows, D)
            s, bb = ln_params(D)
            want = route32 if dtype == torch.float32 else route16
            before = dict(es.ROUTES)
            got = es.layernorm_rows(xr, s, bb)
            if es.ROUTES != {**before, want: before[want] + 1}:
                fail(f"layernorm_rows {tag} M={rows} D={D} offset {off}: "
                     f"routes {es.ROUTES} (before {before}), not {want}")
            compare(f"layernorm_rows {tag} M={rows} D={D} x offset {off} "
                    f"(route {want})", got,
                    es.layernorm_rows_reference(xr, s, bb), dtype,
                    "layernorm_rows" if main_rec and rows == M else None)
        for (Bs, Hs, qk) in ((64, H, False), (64, H, True), (512, H, False),
                             (64, 2, True)):
            w = stack_weights(L, d, Hs, dff, dtype)
            xs = randn(Bs, T, d, dtype=dtype)
            km = key_mask(Bs, T)
            name = (f"fused_encoder_stack {tag} L={L} B={Bs} T={T} d={d} "
                    f"H={Hs} qk_norm={qk}")
            got = es.fused_encoder_stack(xs, km, w, num_heads=Hs, qk_norm=qk)
            ref = es.encoder_stack_reference(xs, km, w, num_heads=Hs,
                                             qk_norm=qk)
            if dtype == torch.float32:
                compare(name, got, ref, dtype)
                continue
            # bf16 over L layers: 1-ulp rounding flips of either side grow
            # chaotically through the stack, so hold the kernel to the
            # float32 computation of the same inputs, as accurate as the
            # plain bf16 path within STACK_BF16_FACTOR
            w32 = {k: v.float() for k, v in w.items()}
            ref32 = es.encoder_stack_reference(xs.float(), km, w32,
                                               num_heads=Hs, qk_norm=qk)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{name}: kernel output not finite")
            err_k = (got.float() - ref32).abs().max().item()
            err_p = (ref.float() - ref32).abs().max().item()
            rel = (got.float() - ref.float()).abs().max().item() / \
                ref.float().abs().max().item()
            print(f"check {name}: vs float32 kernel {err_k:.3e} plain "
                  f"{err_p:.3e} (kernel <= {STACK_BF16_FACTOR} x plain); "
                  f"vs plain rel {rel:.3e}")
            if not err_k <= STACK_BF16_FACTOR * err_p:
                fail(f"{name}: kernel error {err_k:.3e} vs float32 above "
                     f"{STACK_BF16_FACTOR} x the plain path's {err_p:.3e}")

    check_decode_kernels(randn, gen, dev, errs)
    check_train_kernels(randn, gen, dev, errs, compare)
    check_token_ce(randn, gen, dev, errs, compare)
    check_redesigned_modes(randn, gen, dev, compare)
    check_dropout_prng(dev, errs)
    check_flash_attention(randn, gen, dev, errs, compare)
    check_decode_step(randn, gen, dev, errs)

    # ---- 4. main path: the port's sbir CLI at the sbir preset's width ------
    with tempfile.TemporaryDirectory() as tmp:
        out_npz = os.path.join(tmp, "sbir_z.npz")
        argv = ["sbir", "--preset", "sbir", "--init-seed", "0",
                "--device", "cuda", "--max-batches", str(MAIN_BATCHES),
                "--loader-arg", f"sketches_per_epoch={SKETCHES_PER_EPOCH}",
                "--output", out_npz]
        print("main path: python -m sketchformer_tpu_torch.cli "
              + " ".join(argv))
        buf = io.StringIO()
        for m in counters:
            m.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(es.LAUNCHES)
        if rc != 0:
            fail(f"cli sbir returned {rc}")
        metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"sbir metrics: {json.dumps(metrics)} ({main_s:.1f} s)")
        print(f"launches during the main path: {json.dumps(launches)}")
        for name in EMBED_KERNELS:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the main path")
        # bf16 at H=8 / Dh=32: every batch on the packed stack, each
        # attention the ragged forward's persistent walk, none the padded
        # kernel
        stacks = {k: es.ROUTES[k] for k in ("packed", "padded")}
        print(f"encoder stacks during the main path: {json.dumps(stacks)}; "
              f"ragged routes {json.dumps(es.RAGGED_ROUTES)}")
        if launches["encoder_attention"] or stacks["padded"] or \
                launches["ragged_attention"] != \
                stacks["packed"] * SBIR["L"] or \
                es.RAGGED_ROUTES["persistent"] != \
                launches["ragged_attention"]:
            fail(f"the sbir path's stacks {stacks}, launches {launches}, "
                 f"ragged routes {es.RAGGED_ROUTES}")
        main_path_routes("cli sbir")
        if launches["linear_nt"] or launches["linear_tn"]:
            fail("the sbir path launched a backward kernel")
        if dc.LAUNCHES["decode_chunk"] or da.LAUNCHES["decode_attention"]:
            fail("the sbir path launched a decode kernel")
        if fa.LAUNCHES["flash_attention_fwd"]:
            fail("the pre-LN sbir path launched K8 (its stack declined)")
        with np.load(out_npz) as data:
            Z, labels = data["embeddings"], data["labels"]

    args = cli.build_parser().parse_args(argv)
    model, loader = cli.build_model_and_loader(args)
    cfg = model.config
    n_real = MAIN_BATCHES * 64
    if Z.shape != (n_real, cfg.lowerdim) or labels.shape != (n_real,):
        fail(f"embeddings {Z.shape} / labels {labels.shape}, expected "
             f"({n_real}, {cfg.lowerdim})")
    if not np.isfinite(Z).all():
        fail("embeddings not finite")
    for k in ("top1", "top5", "top10", "mAP"):
        if not 0.0 <= metrics[k] <= 1.0:
            fail(f"sbir metric {k}={metrics[k]} outside [0, 1]")
    with torch.inference_mode():
        logits = model.classify(torch.from_numpy(Z).to(dev))
    torch.cuda.synchronize()
    if tuple(logits.shape) != (n_real, cfg.num_classes) or \
            not torch.isfinite(logits).all():
        fail(f"classifier logits {tuple(logits.shape)} bad or not finite")
    print(f"classifier logits {tuple(logits.shape)} finite; top1 vs labels "
          f"{(logits.argmax(1).cpu().numpy() == labels).mean():.4f}")

    batches = loader.get_validation_set(max_batches=MAIN_BATCHES)
    shares = [float(np.asarray(model.enc_key_mask(b["enc"], None)).mean())
              for b in batches]
    print(f"main path's loader batches: valid share of the positions "
          f"{np.mean(shares):.4f} (min {min(shares):.4f}, max "
          f"{max(shares):.4f}; {len(batches)} batches of "
          f"{batches[0]['enc'].shape})")
    enc = torch.from_numpy(batches[0]["enc"]).to(dev)
    main_rows = packed_rows(model, batches[0]["enc"], None, dev)
    if main_rows is None:
        fail("the main path's first batch was not packed")
    main_rows = main_rows.to(dev)
    with torch.inference_mode():
        weights = model.encoder.stacked_weights()
        km = model.enc_key_mask(enc, None)
        x_main = model.embed_input(enc)
        kw_main = dict(num_heads=cfg.num_heads, qk_norm=cfg.qk_norm)
        for route, z_kernel, enc_out in (
                ("padded", fast_embed(model, enc, None, weights),
                 es.encoder_stack_reference(x_main, km, weights, **kw_main)),
                ("packed", fast_embed(model, enc, None, weights, main_rows),
                 es.encoder_stack_packed_reference(x_main, main_rows, weights,
                                                  **kw_main))):
            z_plain = model.bottleneck.pooled_z(enc_out, km).float()
            compare(f"main-path z, {route} kernel stack vs its plain stack "
                    f"(one batch of 64)", z_kernel, z_plain,
                    cfg.compute_dtype)
        # the ragged forward against its plain version on that batch's rows
        dh_main = cfg.d_model // cfg.num_heads
        m_main = int(main_rows.index.shape[0])
        for qk in (False, True):
            qkv = randn(m_main, 3 * cfg.d_model, dtype=torch.bfloat16)
            norms = tuple(p for _ in range(2) for p in ln_params(dh_main)) \
                if qk else None
            kw_main = dict(num_heads=cfg.num_heads, qk_norm=norms)
            compare(f"ragged_attention bfloat16 main-path batch ({m_main} "
                    f"rows of 64 x {enc.shape[1]}) H={cfg.num_heads} "
                    f"Dh={dh_main} qk_norm={qk}",
                    es.ragged_attention(qkv, main_rows, **kw_main),
                    es.ragged_attention_reference(qkv, main_rows, **kw_main),
                    torch.bfloat16, "ragged_attention")

    # ---- 4b. main paths: AR reconstruction and interpolation --------------
    seeded = ["--init-seed", "0", "--device", "cuda"]
    enc_kernels = ("linear", "encoder_attention", "layernorm_rows")

    def drive(argv, needs):
        """One CLI run with every counter reset just before and read just
        after; fails unless each kernel in ``needs`` launched."""
        for m in counters:
            m.reset_launches()
        print("main path: python -m sketchformer_tpu_torch.cli "
              + " ".join(argv))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for m in counters for k, v in m.LAUNCHES.items()}
        if rc != 0:
            fail(f"cli {argv[0]} returned {rc}")
        print(f"  {buf.getvalue().strip().splitlines()[-1]} ({secs:.1f} s)")
        print(f"  launches: {json.dumps(got)}")
        main_path_routes(f"cli {argv[0]}")
        for k in needs:
            if got[k] <= 0:
                fail(f"kernel {k} was not launched by cli {' '.join(argv)}")
        if got["decode_step"]:
            fail(f"cli {argv[0]} launched the whole-step kernel")
        return got

    def check_sketches(path, n):
        with np.load(path) as data:
            pts, offs = data["points"], data["offsets"]
            extra = {k: data[k] for k in data.files
                     if k not in ("points", "offsets", "labels")}
        if offs.shape != (n + 1,) or offs[0] != 0 or \
                np.any(np.diff(offs) < 0) or offs[-1] != len(pts):
            fail(f"{path}: offsets {offs.shape} do not index {n} sketches")
        if pts.ndim != 2 or pts.shape[1] != 3 or not np.isfinite(pts).all():
            fail(f"{path}: points {pts.shape} bad or not finite")
        if not np.isin(pts[:, 2], (0.0, 1.0)).all():
            fail(f"{path}: pen column outside {{0, 1}}")
        for k, v in extra.items():
            if not np.isfinite(v).all():
                fail(f"{path}: {k} not finite")
        print(f"  {n} sketches, {len(pts)} points, "
              f"{int((np.diff(offs) > 0).sum())} non-empty, finite")
        return extra

    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return ["--output", os.path.join(tmp, name)]

        got = drive(["decode", "--preset", "ar_decode", *seeded,
                     *out("ar.npz")], ("decode_chunk",) + enc_kernels)
        launches["decode_chunk"] = got["decode_chunk"]
        # the padded encoder_attention's main path since sbir's batches take
        # the ragged forward: the decode prologue's encoder
        launches["encoder_attention"] = got["encoder_attention"]
        check_sketches(os.path.join(tmp, "ar.npz"), 64)
        drive(["interpolate", "--preset", "ar_decode", *seeded,
               *out("interp.npz")], ("decode_chunk",) + enc_kernels)
        extra = check_sketches(os.path.join(tmp, "interp.npz"), 8)
        if extra["embeddings"].shape != (8, 256):
            fail(f"interpolation path {extra['embeddings'].shape}")
        got = drive(["decode", "--preset", "cont2cont_mdn", *seeded,
                     *out("mdn.npz")], ("decode_cont_chunk",) + enc_kernels)
        launches["decode_cont_chunk"] = got["decode_cont_chunk"]
        check_sketches(os.path.join(tmp, "mdn.npz"), 64)
        got = drive(["decode", "--preset", "cont2cont_mdn", *seeded,
                     "--temperature", "0.7", *out("mdn_t.npz")],
                    ("decode_attention",) + enc_kernels)
        launches["decode_attention"] = got["decode_attention"]
        if got["decode_cont_chunk"]:
            fail("temperature sampling ran the greedy chunk kernel")
        check_sketches(os.path.join(tmp, "mdn_t.npz"), 64)

    # each greedy decode, in float32 at the same widths, against the plain
    # teacher-forced forward of its own output
    def preset_model(preset, *over):
        a = cli.build_parser().parse_args(["decode", "--preset", preset,
                                           *seeded, *over])
        return cli.build_model_and_loader(a)

    model32, loader32 = preset_model("ar_decode", "--hparams",
                                     "dtype=float32")
    _, enc32, _ = cli.first_batch(model32, loader32)
    dc.reset_launches()
    ids = dec.make_token_decoder(model32)(enc32)
    torch.cuda.synchronize()
    if tuple(ids.shape) != (64, AR["T"]) or not dc.LAUNCHES["decode_chunk"]:
        fail(f"f32 token decode {tuple(ids.shape)} without the chunk kernel")
    teacher_forced_check("decode ar_decode f32 on decode_chunk", model32,
                         enc32, None, ids)
    del model32
    mdn32, mloader32 = preset_model("cont2cont_mdn", "--hparams",
                                    "dtype=float32")
    _, encm, maskm = cli.first_batch(mdn32, mloader32)
    for name, kname, early in (("decode_cont_chunk", "decode_cont_chunk",
                                True),
                               ("composed decode_attention",
                                "decode_attention", False)):
        for m in counters:
            m.reset_launches()
        outm = dec.make_cont_decoder(mdn32, early_exit=early)(encm, maskm)
        torch.cuda.synchronize()
        fired = {**dc.LAUNCHES, **da.LAUNCHES}
        if tuple(outm[0].shape) != (64, AR["T"], 2) or not fired[kname]:
            fail(f"f32 MDN decode {tuple(outm[0].shape)} without {kname}")
        teacher_forced_check(f"decode cont2cont_mdn f32 greedy on {name}",
                             mdn32, encm, maskm, outm)
    del mdn32

    # ---- 4c. main path: continuous training, then eval -------------------
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, _ = train_main_path(cli, counters, engines, tmp)
    for k in TRAIN_KERNELS:
        launches[k] = train_launches[k]
    # linear_tn, the bf16 attention backward and layernorm_bwd each add
    # their partial sums in their own launches
    print(f"sum_rows launches a cont2cont_mdn train step: "
          f"{train_launches['sum_rows'] / TRAIN_STEPS:.1f} (before the bias "
          f"gradients moved into linear_tn: {SUM_ROWS_PER_STEP_BEFORE}; "
          f"before the attention backward's qk-norm sums moved into its "
          f"launches: {SUM_ROWS_PER_STEP_BEFORE_K5}; before LayerNorm's "
          f"parameter gradients moved into layernorm_bwd: "
          f"{SUM_ROWS_PER_STEP_BEFORE_LN}); linear_tn "
          f"{train_launches['linear_tn'] / TRAIN_STEPS:.1f}, layernorm_bwd "
          f"{train_launches['layernorm_bwd'] / TRAIN_STEPS:.1f}")

    # ---- 4c'. main path: float32 training, the one caller of sum_rows ----
    with tempfile.TemporaryDirectory() as tmp:
        launches["sum_rows"] = train_f32_main_path(cli, counters,
                                                   tmp)["sum_rows"]
    print(f"  sum_rows: {launches['sum_rows']} launches in "
          f"{F32_TRAIN_STEPS} float32 steps of {F32_TRAIN_LAYERS} layers and "
          f"the final eval")

    # ---- 4d. main path: prep-data shards, token-mode training, eval ------
    # (the shards stay for phase 4g)
    shards_tmp = tempfile.TemporaryDirectory()
    shards = prep_shards(cli, shards_tmp.name)
    with tempfile.TemporaryDirectory() as tmp:
        tok_launches = train_tok_main_path(cli, counters, engines, tmp,
                                           shards)
    for k in TOK_KERNELS:
        launches[k] = tok_launches[k]
    print(f"sum_rows launches a token train step: "
          f"{tok_launches['sum_rows'] / TRAIN_STEPS:.1f} (before LayerNorm's "
          f"parameter gradients moved into layernorm_bwd: "
          f"{SUM_ROWS_PER_TOK_STEP_BEFORE_LN})")

    # ---- 4e. main paths of the post-LN model: sbir, decode, train, eval ---
    # (norm_first=False: the fused stacks and engines decline, the composed
    # layers' self-attention runs K8)
    with tempfile.TemporaryDirectory() as tmp:
        engines.reset_seen()
        got = drive(["sbir", "--preset", "sbir", *seeded, "--max-batches",
                     "4", "--loader-arg",
                     f"sketches_per_epoch={SKETCHES_PER_EPOCH}", *POST_LN,
                     "--output", os.path.join(tmp, "z.npz")],
                    ("flash_attention_fwd",))
        if any(got[k] for k in enc_kernels + ("ragged_attention",)) or \
                got["flash_attention_bwd"]:
            fail("the post-LN sbir path launched an encoder-stack or a "
                 "backward kernel")
        if ("embed", "composed", "post-LN config") not in engines._seen:
            fail("the post-LN sbir path did not decline the fast engine")
        with np.load(os.path.join(tmp, "z.npz")) as data:
            if not np.isfinite(data["embeddings"]).all():
                fail("post-LN embeddings not finite")
        got = drive(["decode", "--preset", "ar_decode", *seeded, *POST_LN,
                     "--output", os.path.join(tmp, "ar.npz")],
                    ("flash_attention_fwd", "decode_attention"))
        if got["decode_chunk"]:
            fail("the post-LN decode ran the chunk kernel")
        check_sketches(os.path.join(tmp, "ar.npz"), 64)
    with tempfile.TemporaryDirectory() as tmp:
        post_launches, post_steps = train_main_path(cli, counters, engines,
                                                    tmp, post_ln=True)
    for k in ("flash_attention_fwd", "flash_attention_bwd"):
        launches[k] = post_launches[k]
        print(f"  {k}: {post_launches[k]} launches in {post_steps} post-LN "
              f"train steps and the final eval")

    # ---- 4f. the whole-step kernel's step loop (no CLI path runs it) -------
    step_model, step_loader = preset_model("ar_decode")
    _, enc_s, _ = cli.first_batch(step_model, step_loader)
    for m in counters:
        m.reset_launches()
    ids = make_step_token_decoder(step_model)(enc_s)
    torch.cuda.synchronize()
    launches["decode_step"] = dstep.LAUNCHES["decode_step"]
    if tuple(ids.shape) != (64, AR["T"]) or \
            launches["decode_step"] != AR["T"] or \
            not bool(((ids >= 0) & (ids < AR["V"])).all()):
        fail(f"step loop: ids {tuple(ids.shape)}, "
             f"{launches['decode_step']} launches")
    print(f"main path: make_step_token_decoder on ar_decode (B=64, "
          f"T={AR['T']}): {launches['decode_step']} decode_step launches; "
          f"routes {json.dumps(dstep.ROUTES)}")
    if step_model.config.compute_dtype == torch.bfloat16 and \
            dstep.ROUTES != {"cluster": AR["T"], "rows": 0}:
        fail(f"step loop: bf16 launches off the cluster kernel: "
             f"{dstep.ROUTES}")
    del step_model

    # ---- 4g. main path: pretrain_full by 2 ranks on the card --------------
    with shards_tmp, tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ddp_launches = ddp_main_path(cli, shards, tmp, gpu)
    print(f"ddp phase: {time.perf_counter() - t0:.1f} s; rank 0's launches "
          f"in {DDP_STEPS} steps and the eval: " + ", ".join(
              f"{k} {ddp_launches[k]}" for k in STACK_KERNELS + TOK_KERNELS)
          + f" [{gpu}]")

    # ---- 4h. main path: reference weights imported, then served ----------
    with tempfile.TemporaryDirectory() as tmp:
        import_main_path(cli, counters, tmp, gpu)

    # ---- 5. times ----------------------------------------------------------
    def cuda_ms(fn, iters=20, warm=3):
        for _ in range(warm):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def paired(kernel_fn, plain_fn, iters=20, warm=3):
        """plain, kernel, kernel, plain on one card; means of each pair."""
        p1 = cuda_ms(plain_fn, iters, warm)
        k1 = cuda_ms(kernel_fn, iters, warm)
        k2 = cuda_ms(kernel_fn, iters, warm)
        p2 = cuda_ms(plain_fn, iters, warm)
        return (k1 + k2) / 2, (p1 + p2) / 2

    dt = cfg.compute_dtype
    times = {}
    lib = {}    # one PyTorch call computing the same function, where one does
    B = 64
    M = B * T
    k_ms, p_ms, lib["linear"] = linear_spreads(randn, gpu)
    times["linear"] = (k_ms, p_ms)
    # the rule-2 kernels at their main-path shapes as device time (the JSON
    # line takes layernorm_rows at the sbir rows, K12 midway through a
    # decode and K7's emit at its pretrain_full site)
    r2_cases = rule2_cases(randn)
    r2 = rule2_spreads(r2_cases, gpu)
    emit_sass_floors(sass, gpu)
    r2_main = (("layernorm_rows", (M, d)),
               ("decode_attention", (B * H, d // H, AR["T"] // 2)),
               ("decode_step", (B, AR["T"] // 2)),
               ("emit_dropout_bits", EMIT_SITE))
    for name, shape in r2_main:
        sp = r2[(name, shape)]
        times[name] = (sp["kernel"][0], sp["plain"][0])
        lib[name] = None if sp["lib"] is None else sp["lib"][0]
    with torch.inference_mode():
        # encoder_attention on the tensor cores: the sbir call (no qk-norm),
        # cont2cont_mdn's encoder (qk-norm, each key normalised once a
        # block) and the B=512 / T=96 / H=2 training geometry
        ea = encoder_attention_spread(dev, B, T, H, d // H, False, gpu, randn)
        times["encoder_attention"], lib["encoder_attention"] = ea[:2], ea[2]
        encoder_attention_spread(dev, B, T, H, d // H, True, gpu, randn)
        encoder_attention_spread(dev, CONT_TRAIN["B"], CONT_TRAIN["T"],
                                 CONT_TRAIN["H"],
                                 CONT_TRAIN["d"] // CONT_TRAIN["H"], False,
                                 gpu, randn)
        # the ragged forward at the main path's shapes (the sbir loader's
        # first batch, its valid rows): the kernels line's entry
        qkv_main = randn(m_main, 3 * d, dtype=dt)
        kw_main = dict(num_heads=H)
        sp = spread_ms(
            lambda: es.ragged_attention(qkv_main, main_rows, **kw_main),
            lambda: es.ragged_attention_reference(qkv_main, main_rows,
                                                  **kw_main), None)
        tiles = spread_ms(lambda: es.ragged_attention_on(
            "tiles", qkv_main, main_rows, **kw_main), None, None)["kernel"]
        times["ragged_attention"] = (sp["kernel"][0], sp["plain"][0])
        lib["ragged_attention"] = None
        b_ms, b_by = bound(*ragged_work(main_rows, H, d // H))
        print(f"time ragged_attention (bf16, the sbir loader's batch: "
              f"{m_main} valid rows of 64 x {T}, H={H}, Dh={d // H}; device "
              f"time, median of {SPREAD_CALLS}): kernel (the persistent "
              f"walk) {fmt_spread(sp['kernel'])}, the 64-row query blocks' "
              f"grid (\"tiles\") {fmt_spread(tiles)}, plain (a loop over "
              f"the sketches) {fmt_spread(sp['plain'])}; bound {b_ms:.4f} ms "
              f"({b_by}) [{gpu}]")
    # the ragged attention at the embed cell's batch beside the padded one
    packed_embed_times(dev, gpu)

    # decode: per chunk (the mean over a T=192 decode's 12 chunks), kernel
    # vs plain
    from sketchformer_tpu_torch.data.pipeline import PEN_END
    from sketchformer_tpu_torch.data.tokenizer import EOS_ID, PAD_ID, SOS_ID

    T, K, H = AR["T"], AR["K"], AR["H"]
    B = 64
    nchunks = T // K

    def chunk_state(model, enc, mask=None):
        cfg = model.config
        ops = decoder_operands(model)
        _, memory, _ = model.encode(enc, mask)
        ck, cv = dc.precompute_cross_kv(memory, ops["w"], num_heads=H,
                                        qk_norm=cfg.qk_norm)
        kc = torch.zeros((cfg.num_layers, enc.shape[0] * H, T,
                          cfg.d_model // H), dtype=cfg.compute_dtype,
                         device=dev)
        pos = model.dec_embed.table[:T].to(cfg.compute_dtype)
        return cfg, ops, ck, cv, kc, torch.zeros_like(kc), pos

    with torch.inference_mode():
        model, loader = preset_model("ar_decode", "--loader-arg",
                                     "sketches_per_epoch=4096")
        vb = loader.get_validation_set(max_batches=8)
        enc64 = torch.from_numpy(vb[0]["enc"]).to(dev)
        enc512 = torch.from_numpy(np.concatenate([b["enc"] for b in vb])
                                  ).to(dev)
        if enc512.shape[0] != 8 * B:
            fail(f"only {enc512.shape[0]} validation sketches for B=512")
        cfg, *_ = state64 = chunk_state(model, enc64)

        def token_chunks(fn, state):
            _, ops, ck, cv, kc, vc, pos = state
            Bs = ck.shape[1] // H

            def run():
                prev = torch.full((Bs,), SOS_ID, dtype=torch.int32,
                                  device=dev)
                fin = torch.zeros((Bs,), dtype=torch.int32, device=dev)
                for t in range(0, T, K):
                    ids, fin = fn(prev, fin, kc, vc, ck, cv, ops["emb"],
                                  pos[t:t + K], ops["head_w"], ops["head_b"],
                                  ops["w"], t, num_heads=H,
                                  qk_norm=cfg.qk_norm, pad_id=PAD_ID,
                                  sos_id=SOS_ID, eos_id=EOS_ID)
                    prev = ids[:, -1].contiguous()
            return run

        k_ms, p_ms = paired(token_chunks(dc.decode_chunk, state64),
                            token_chunks(dc.decode_chunk_reference, state64),
                            iters=2, warm=1)
        times["decode_chunk"] = (k_ms / nchunks, p_ms / nchunks)
        # the kernel alone at B=512 (the plain version's time there is not
        # read)
        big_ms = {"decode_chunk": cuda_ms(token_chunks(
            dc.decode_chunk, chunk_state(model, enc512)), 2, 1) / nchunks}

        mdn, mloader = preset_model("cont2cont_mdn")
        mvb = mloader.get_validation_set(max_batches=8)
        mcfg, *_ = mstate64 = chunk_state(
            mdn, torch.from_numpy(mvb[0]["enc"]).to(dev),
            torch.from_numpy(mvb[0]["enc_mask"]).to(dev))
        if mvb[0]["enc"].shape[0] != B:
            fail(f"{mvb[0]['enc'].shape[0]} MDN validation sketches a "
                 f"batch, not {B}")

        def mdn_chunks(fn, state):
            _, mops, mck, mcv, mkc, mvc, mpos = state
            Bs = mck.shape[1] // H

            def run():
                row = torch.zeros((Bs, 5), device=dev)
                row[:, 3] = 1.0
                fin = torch.zeros((Bs,), dtype=torch.int32, device=dev)
                for t in range(0, T, K):
                    xy, pen, _, fin = fn(
                        row, fin, mkc, mvc, mck, mcv, mops["in_w"],
                        mops["in_b"], mpos[t:t + K], mops["head_w"],
                        mops["head_b"], mops["w"], t, num_heads=H,
                        num_mixtures=mcfg.num_mixtures, qk_norm=mcfg.qk_norm,
                        pen_end=PEN_END)
                    row = torch.cat([xy[:, -1], torch.nn.functional.one_hot(
                        pen[:, -1].long(), 3).float()], -1)
            return run

        k_ms, p_ms = paired(mdn_chunks(dc.decode_cont_chunk, mstate64),
                            mdn_chunks(dc.decode_cont_chunk_reference,
                                       mstate64), iters=2, warm=1)
        times["decode_cont_chunk"] = (k_ms / nchunks, p_ms / nchunks)
        menc512, mmask512 = (torch.from_numpy(np.concatenate(
            [b[key] for b in mvb])).to(dev) for key in ("enc", "enc_mask"))
        if menc512.shape[0] != 8 * B:
            fail(f"only {menc512.shape[0]} MDN validation sketches for "
                 f"B=512")
        big_ms["decode_cont_chunk"] = cuda_ms(mdn_chunks(
            dc.decode_cont_chunk, chunk_state(mdn, menc512, mmask512)),
            2, 1) / nchunks
        del mdn

    # beside each chunk: its bound (the self-attention cache rows read once
    # a step) and
    # the bf16 cluster kernel's serial floor, its chain of cluster barriers
    # (8 a layer and one for the pick, each step) at one barrier's measured
    # cost in clusters of the plan's size
    chunk_work = serving_kernel_work(
        B=B, T=T, d=AR["d"], H=H, dff=AR["dff"], L=AR["L"], V=AR["V"], K=K,
        N_mdn=6 * MDN_MIXTURES + 3, Mq=AR["Mq"])
    barriers = 8 * AR["L"] + 1
    for name in ("decode_chunk", "decode_cont_chunk"):
        k_ms, p_ms = times[name]
        cont = name == "decode_cont_chunk"
        plan = dc.cluster_plan(
            B, d=AR["d"], H=H, dff=AR["dff"],
            N=6 * MDN_MIXTURES + 3 if cont else AR["V"], Tmax=T, Mq=AR["Mq"],
            cont=cont, max_clusters=dc.cluster_fit(
                torch.cuda.current_device(),
                dc.KIND_MDN if cont else dc.KIND_TOKEN))
        bar_us = cluster_barrier_us(dev, plan["C"], -(-B // plan["G"]))
        b_ms, b_by = bound(*chunk_work[name])
        print(f"time {name} (B={B}, L={cfg.num_layers}, d={cfg.d_model}, "
              f"H={H}, K={K}, {str(dt)[6:]}, per chunk, mean of the "
              f"{nchunks} chunks of T={T}): kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}); serial floor "
              f"{barriers} cluster barriers a step x {K} steps x "
              f"{bar_us:.3f} us = {barriers * K * bar_us / 1e3:.4f} ms "
              f"(clusters of {plan['C']}, {plan['G']} rows each); B=512: "
              f"kernel {big_ms[name]:.3f} ms per chunk [{gpu}]")

    # the training kernels and the stacks
    for name, (k_ms, p_ms, l_ms) in {
            **train_kernel_times(randn, dev, gpu, paired),
            **norm_times(randn, gpu)}.items():
        times[name] = (k_ms, p_ms)
        lib[name] = l_ms
    optimizer_times(dev, gpu)
    stack_times(dev, gpu, cuda_ms)
    for name, (k_ms, p_ms, l_ms) in token_ce_times(
            randn, gen, dev, gpu, paired).items():
        times[name] = (k_ms, p_ms)
        lib[name] = l_ms
    for name, (k_ms, p_ms, l_ms) in flash_times(
            randn, gen, dev, gpu, paired).items():
        times[name] = (k_ms, p_ms)
        lib[name] = l_ms
    print(f"time decode_step (bf16, B=64, L={AR['L']}, t={AR['T'] // 2}, "
          f"one step, device time, median of {SPREAD_CALLS}): kernel "
          f"{times['decode_step'][0]:.4f} ms, plain "
          f"{times['decode_step'][1]:.4f} ms; decode_chunk per step "
          f"{times['decode_chunk'][0] / AR['K']:.4f} ms (a {AR['K']}-step "
          f"chunk / {AR['K']}) [{gpu}]")
    rule2_kernel_events(r2_cases, gpu)
    del r2_cases

    work = serving_kernel_work(B=64, T=SBIR["T"], d=SBIR["d"], H=SBIR["H"],
                               dff=SBIR["dff"], L=SBIR["L"], V=AR["V"],
                               K=AR["K"], N_mdn=6 * MDN_MIXTURES + 3)
    work.update(train_kernel_work(*(MDN[k] for k in ("B", "T", "d", "H",
                                                     "dff"))))
    work.update(token_kernel_work(TRAIN["B"] * TRAIN["T"], TRAIN["d"],
                                  TRAIN["V"]))
    work.update(flash_work(*FLASH_SHAPES["cont2cont_mdn"]))
    work.update({name: rule2_work(name, *shape) for name, shape in r2_main})
    work["ragged_attention"] = ragged_work(main_rows, H, d // H)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "jaxlib"))
    if leaked:
        fail(f"JAX was imported: {leaked[:5]}")

    kernels = []
    for name in REPLACES:
        b_ms, b_by = bound(*work[name])
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib.get(name)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
