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
   computation of its inputs, as accurate as the plain bf16 path); then
   the decode kernels: ``decode_attention`` at B=64, H=8/Dh=32, Tmax=192
   with cache_len 1, 17 and 192 (and at Dh=64 and 128), ``decode_chunk``
   at the ``ar_decode`` width (B=64, L=8, d=256, H=8, dff=512, V=10,004,
   K=16) from chunk starts 0, 16 and 176 with some rows already finished,
   qk-norm off and on, and at H=2/Dh=128, ``decode_cont_chunk`` at the
   ``cont2cont_mdn`` width (20 mixtures). Both sides of a chunk start from
   the same cache; picks must be equal up to each row's first near tie of
   the plain version (top-two gap below 1e-3 in f32, below one bf16 ulp
   of the row's top value in bf16), and new k/v rows and xy close over
   those steps; then the training kernels at the ``cont2cont_mdn`` width
   (B=64, T=192, d=256, dff=512) with H=8/Dh=32 and qk-norm and at
   H=2/Dh=128 without: ``linear_nt`` and ``linear_tn`` (one encoder
   layer's four backward products, with dropout masks and the ReLU gate),
   ``linear``'s dropout epilogue, ``attention_fwd`` / ``attention_bwd_q``
   / ``attention_bwd_kv`` (self-attention under a key mask, and
   cross-attention to 4 memory rows), ``layernorm_bwd``, ``sum_rows``; and
   each whole train stack's forward and backward (L=2, dropout 0.1),
   float32 within a relative L2 error of 1e-3 of the plain version, bf16
   within 2x the plain bf16 path's error against float32; then the fused
   vocab-CE head (K6: ``token_ce_fwd``, ``token_ce_dx``, ``token_ce_dw``)
   at the JAX benchmark's ``train`` shape (bf16, M 49,152, d 256, V 10,004)
   and in f32 at M 4,096: ll, lse, dx, dW and db within TOL, corr equal
   away from near ties, and the bf16 kernels against the f32 computation;
   and the in-kernel dropout draw (K7): ``emit_dropout_bits`` bit-equal to
   the plain Philox at (16, 512, 96, 256) with the kept share within 1e-3,
   and each 'prng' train stack equal to the 'bits' stack fed the emitted
   bytes (output and every gradient, torch.equal; f32 and bf16);
4. main paths, each with every launch counter reset just before and read
   just after: the port's ``sbir`` CLI at the full width of the ``sbir``
   preset (seeded random weights) over 16 batches of 64 from the preset's
   synthetic 345-class loader; then classifier logits on z, and the
   kernel z against the plain-path z on one batch. Then the port's
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
   kernel of the train stacks launches, neither stack declines its
   kernels, the loss is finite and falls; and ``eval`` on its checkpoint,
   whose loss the composed model matches; then the same for token-mode
   training: ``train`` on ``pretrain_full`` with a synthetic 345-class
   token loader (its shards are not in the repo) and warmup 500, through
   the K6 kernels, the stacks drawing their dropout in-kernel (no dropout
   byte tensor drawn) and the composed sites through the emit kernel;
5. times: kernel vs plain (CUDA events after warm-up), the end-to-end
   embed rate, per-chunk and per-call decode kernel times, and the
   whole-decode p50 at B=64/T=192 and sketches/s at B=512 for the chunk
   engine and the composed decoder; each training kernel (one layer's
   calls) against its plain version and one PyTorch call where one
   computes the same function; the train stacks' forward + backward; K6
   and the emit kernel; the train step p50 and sketches/s at the
   ``cont2cont_mdn`` shape, the JAX benchmark's ``cont_train`` shape
   (B=512, T=96, H=2; 'prng' and 'bits' dropout) and its token cells
   ``train`` (H=2) and ``train_h8`` (H=8), with a ``torch.profiler``
   breakdown of each; each with the card's name and power limit. Every kernel's bound (the least time for its bytes and
   operations at the card's published peaks) is computed from the timed
   calls' shapes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "sketchformer_tpu_torch/csrc/"
# source of each Hopper kernel, and the TPU kernel it replaces (the body of
# fused_encoder_stack, whose attention and qk-norm at H=8 run in
# pallas_packed.group_attn_fwd; at H=8/Dh=32 the JAX decode runs the
# lane-packed chunk kernels)
SOURCES = {"linear": "encoder_stack.cu", "encoder_attention":
           "encoder_stack.cu", "layernorm_rows": "encoder_stack.cu",
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
           "emit_dropout_bits": "dropout_prng.cu"}
# the training kernels replace parts of the bodies of the TPU training
# kernels: the backward products and the row LayerNorm backward of
# _layer_bwd_kernel (:102, _ln_bwd32 :80, the cross-cell accumulation
# :214), the decoder's attention (_dec_stack_kernel :87) and the small-head
# attention backward (group_attn_bwd)
REPLACES = {
    "linear": "sketchformer_tpu/ops/pallas_encoder.py:140",
    "encoder_attention": "sketchformer_tpu/ops/pallas_packed.py:169",
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
}
# max |kernel - plain| / max |plain| allowed, by dtype
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the whole bf16 stack: max |kernel - f32| <= this x max |plain bf16 - f32|
STACK_BF16_FACTOR = 2.0
SBIR = dict(T=192, d=256, H=8, dff=512, L=8)
SKETCHES_PER_EPOCH = 345 * 32   # 1380 validation sketches -> >= 16 batches
MAIN_BATCHES = 16
AR = dict(d=256, H=8, dff=512, L=8, V=10004, T=192, K=16, Mq=4)
MDN_MIXTURES = 20                 # cont2cont_mdn
# bf16 decode chunks: a pick is compared where the plain version's top two
# values are at least this many bf16 ulps of the top value apart
BF16_TIE_ULPS = 4


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# decode kernels against their plain versions
# ---------------------------------------------------------------------------


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
        for BH, Dh in ((64 * 8, 32), (64 * 4, 64), (64 * 2, 128)):
            q = randn(BH, 1, Dh, dtype=dtype)
            k, v = randn(BH, T, Dh, dtype=dtype), randn(BH, T, Dh, dtype=dtype)
            for n in (1, 17, T):
                got = da.decode_attention(q, k, v, n)
                torch.cuda.synchronize()
                want = da.decode_attention_reference(q, k, v, n)
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                tol = TOL[tag]
                print(f"check decode_attention {tag} B*H={BH} Dh={Dh} "
                      f"Tmax={T} cache_len={n}: max_abs_err {err:.3e} rel "
                      f"{rel:.3e} (tol {tol:.0e})")
                if not torch.isfinite(got).all() or not rel <= tol:
                    fail(f"decode_attention: rel err {rel:.3e}")
                if main_rec and Dh == 32:
                    errs["decode_attention"] = max(errs["decode_attention"],
                                                   err)
        # B=64 runs one row per block; a batch above the SM count two
        # (the last block half empty)
        big = torch.cuda.get_device_properties(dev).multi_processor_count + 5
        cases = [(False, 8, qk, t0, 64) for qk in (False, True)
                 for t0 in (0, 16, T - K)]
        cases += [(False, 2, True, 16, 64), (False, 8, False, 16, big),
                  (True, 8, True, 0, 64), (True, 8, True, 176, 64),
                  (True, 2, False, 16, 64), (True, 8, True, 16, big)]
        for cont, H, qk, t0, B in cases:
            N = 6 * MDN_MIXTURES + 3 if cont else V
            ops = chunk_operands(randn, gen, dev, B=B, L=L, d=d, H=H,
                                 dff=dff, N=N, Tmax=T, Mq=Mq, K=K, t0=t0,
                                 dtype=dtype, cont=cont)
            kv_ref = (ops["k_cache"].clone(), ops["v_cache"].clone())
            kname = "decode_cont_chunk" if cont else "decode_chunk"
            kw = dict(num_heads=H, qk_norm=qk)
            if cont:
                kw["num_mixtures"] = MDN_MIXTURES
            got = getattr(dc, kname)(
                *chunk_args(ops, ops["k_cache"], ops["v_cache"], cont), **kw)
            torch.cuda.synchronize()
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
                    f"N={N} K={K} t0={t0} qk_norm={qk} ({rule})")
            err = held_to_plain(name, got[:-1], want[:-1], margins, checked,
                                (ops["k_cache"], ops["v_cache"]), kv_ref,
                                kv_rows, t0, dtype)
            if not torch.equal(ops["k_cache"][:, :, :t0],
                               kv_ref[0][:, :, :t0]):
                fail(f"{name}: cache rows below t0 changed")
            main_shape = H == 8 and qk == cont and B == 64
            if main_rec and main_shape:
                errs[kname] = max(errs[kname], err)


def teacher_forced_check(name, model, enc, mask, out):
    """Every emitted greedy pick of a whole decode must be the argmax of
    the plain teacher-forced forward given the decoded prefix, except at
    near ties; the MDN xy must be that step's component mean."""
    import torch
    import torch.nn.functional as F

    from sketchformer_tpu_torch.data.pipeline import PEN_END
    from sketchformer_tpu_torch.data.tokenizer import EOS_ID, PAD_ID, SOS_ID
    from sketchformer_tpu_torch.ops.decode_chunk import NEG_INF, tie_margin

    cfg = model.config
    f32 = torch.float32
    if cfg.use_continuous:
        xy, pen, valid = out
        B, T = pen.shape
        prev = torch.cat([xy, F.one_hot(pen.long(), 3).float()], -1)
        sos = torch.zeros((B, 1, 5), device=xy.device)
        sos[..., 3] = 1.0
        dec_in = torch.cat([sos, prev[:, :-1]], 1)
        with torch.inference_mode():
            raw = model(enc, dec_in, mask)["recon"]
        M = cfg.num_mixtures
        comp = raw[..., :M].argmax(-1)
        want_pen = raw[..., 6 * M:].argmax(-1)
        margins = torch.minimum(tie_margin(raw[..., :M], f32),
                                tie_margin(raw[..., 6 * M:], f32))
        want_xy = torch.stack([raw.gather(-1, (M + comp)[..., None])[..., 0],
                               raw.gather(-1, (2 * M + comp)[..., None])
                               [..., 0]], -1)
        live = valid.bool()
        picks, want_picks = pen, want_pen
    else:
        ids = out
        B, T = ids.shape
        dec_in = torch.cat([torch.full((B, 1), SOS_ID, dtype=ids.dtype,
                                       device=ids.device), ids[:, :-1]], 1)
        with torch.inference_mode():
            logits = model(enc, dec_in)["recon"]
        lane = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where((lane == PAD_ID) | (lane == SOS_ID), NEG_INF,
                             logits)
        want_picks = logits.argmax(-1)
        margins = tie_margin(logits, f32)
        ended = torch.cumsum((ids == EOS_ID).int(), 1)
        live = (ended == 0) | ((ended == 1) & (ids == EOS_ID))
        if not torch.all(ids[~live] == PAD_ID):
            fail(f"{name}: a finished row emitted something other than PAD")
        picks = ids
    # the forward reads the decode's own prefix, so a near tie leaves only
    # its own step undecided
    checked = live & (margins >= 1)
    if not torch.equal(picks[checked].long(), want_picks[checked].long()):
        fail(f"{name}: a pick is not the teacher-forced argmax")
    msg = ""
    if cfg.use_continuous:
        err = (xy[checked] - want_xy[checked]).abs().max().item()
        scale = want_xy[checked].abs().max().item()
        if not err <= TOL["float32"] * scale:
            fail(f"{name}: xy differs from the component mean by {err:.3e}")
        if not torch.all(pen[~live] == PEN_END):
            fail(f"{name}: a finished row emitted a pen other than PEN_END")
        msg = f", xy max_abs_err {err:.3e}"
    print(f"check {name}: {int(checked.sum())} of {int(live.sum())} live "
          f"row-steps held to the teacher-forced argmax (the rest are near "
          f"ties){msg}")
    if int(checked.sum()) < int(live.sum()) // 2:
        fail(f"{name}: fewer than half the live steps were checked")


# ---------------------------------------------------------------------------
# the training stacks' kernels (K3 / K4 / K5)
# ---------------------------------------------------------------------------

# cont2cont_mdn (sketchformer_tpu_torch/presets.py): the trunk of the main
# path; cont_train: the JAX benchmark's continuous training shape
MDN = dict(B=64, T=192, d=256, H=8, dff=512, L=8)
CONT_TRAIN = dict(B=512, T=96, d=256, H=2, dff=512, L=8)
TRAIN_STEPS = 30
TRAIN_KERNELS = ("linear_nt", "linear_tn", "attention_fwd", "attention_bwd_q",
                 "attention_bwd_kv", "layernorm_bwd", "sum_rows")
TOK_KERNELS = ("token_ce_fwd", "token_ce_dx", "token_ce_dw",
               "emit_dropout_bits")
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


def layer_tn_calls(o, fn):
    """The four weight-gradient products of one encoder layer's backward."""
    def run():
        ks = dict(drop=o["drop"], thresh=o["thresh"], keep_scale=o["ks"])
        return [fn(o["f1"], o["g"], **ks), fn(o["x"], o["gf"]),
                fn(o["x"], o["g32"], **ks), fn(o["x"], o["gqkv"])]
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


def check_train_kernels(randn, dev, errs, compare):
    """Each training kernel against its plain version at the cont2cont_mdn
    width (H=8/Dh=32, qk-norm) and at H=2/Dh=128 without qk-norm, f32 and
    bf16; then each whole stack's forward and backward."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack as es
    from sketchformer_tpu_torch.ops import norm_train as nt

    B, T, d, dff = (MDN[k] for k in ("B", "T", "d", "dff"))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for H, qk in ((8, True), (2, False)):
            main = dtype == torch.bfloat16 and H == 8
            o = train_operands(randn, dev, B=B, T=T, d=d, H=H, dff=dff,
                               dtype=dtype, qk=qk)
            shape = f"{tag} B={B} T={T} d={d} H={H} qk_norm={qk}"
            if H == 8:   # the products and norms do not depend on H
                for name, calls in (("linear_nt", layer_nt_calls),
                                    ("linear_tn", layer_tn_calls)):
                    got = calls(o, getattr(es, name))()
                    want = calls(o, getattr(es, name + "_reference"))()
                    for i, (g, w) in enumerate(zip(got, want)):
                        compare(f"{name} {shape} call {i}", g, w, dtype,
                                name if main else None)
                ks = dict(drop=o["drop"], thresh=o["thresh"],
                          keep_scale=o["ks"])
                compare(f"linear+dropout {shape}",
                        es.linear(o["h"], o["w2"], o["bvec"], residual=o["x"],
                                  **ks),
                        es.linear_reference(o["h"], o["w2"], o["bvec"],
                                            residual=o["x"], **ks), dtype)
                for i, (g, w) in enumerate(zip(
                        nt.layernorm_bwd(o["x"], o["g32"], o["scale"],
                                         resid=o["g"]),
                        nt.layernorm_bwd_reference(o["x"], o["g32"],
                                                   o["scale"], resid=o["g"]))):
                    compare(f"layernorm_bwd {shape} out {i}", g, w,
                            torch.float32, "layernorm_bwd" if main else None)
                compare(f"sum_rows {shape}", nt.sum_rows(o["gqkv"]),
                        nt.sum_rows_reference(o["gqkv"]), torch.float32,
                        "sum_rows" if main else None)
            for which, name in (("fwd", "attention_fwd"),
                                ("bwd_q", "attention_bwd_q"),
                                ("bwd_kv", "attention_bwd_kv")):
                got = attn_calls(o, H, qk, which, "kernel")()
                want = attn_calls(o, H, qk, which, "plain")()
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
        for decoder in (False, True):
            for H, qk in ((8, True), (2, False)):
                check_train_stack(randn, dev, decoder, H, qk, dtype)


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
# the plain version (see check_train_stack)
STACK_F32_L2 = 1e-3


def check_train_stack(randn, dev, decoder, H, qk, dtype):
    """A whole train stack (L=2, cont2cont_mdn width, dropout on), kernels
    against the plain versions, the output and every gradient.

    f32: a relative L2 error within STACK_F32_L2, not 1e-4 of the largest
    element: a ReLU pre-activation within rounding of zero is gated
    differently by two summation orders; at these sizes (12.6M
    pre-activations a stack) about one a run is, and it moves its row of
    the input gradient by up to 2.5e-3 of the largest element and the
    gradient's L2 by up to 2.2e-4 (on an H100 80GB HBM3). Every kernel alone
    is held to 1e-4 of the largest element above. bf16: held to the f32 computation of the same inputs, at most
    STACK_BF16_FACTOR x the plain bf16 path's relative L2 error. A key bias
    (projection or k-norm) shifts a row's keys alike, so its gradient is
    zero up to rounding: it is held to 1e-4 (f32) of the largest
    gradient."""
    import torch

    from sketchformer_tpu_torch.ops import encoder_stack_train as est

    B, T, d = MDN["B"], MDN["T"], MDN["d"]
    L = 2
    tag = str(dtype).replace("torch.", "")
    name = (f"fused_{'decoder' if decoder else 'encoder'}_stack_train fwd+bwd "
            f"{tag} L={L} B={B} T={T} d={d} H={H} qk_norm={qk} dropout 0.1")
    mod = stack_module(dev, decoder, H, qk, dtype)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = randn(B, T, d)
    mem = randn(B, 4, d)
    gy = randn(B, T, d)
    km = torch.arange(T, device=dev)[None] < torch.randint(
        T // 4, T + 1, (B,), generator=gen, device=dev)[:, None]
    drop = torch.randint(0, 256, ((3 if decoder else 2) * L, B, T, d),
                         dtype=torch.uint8, generator=gen, device=dev)
    args = (mod, x, mem, km, gy, drop, decoder, H, qk)
    got = stack_grads(*args, est.KERNELS, dtype)
    want = stack_grads(*args, est.PLAIN, dtype)
    torch.cuda.synchronize()
    zero = ("key.bias", "k_norm.bias")
    l2 = lambda a, b: (a.float() - b.float()).norm().item() / max(
        b.float().norm().item(), 1e-30)
    if dtype == torch.float32:
        top = max(w.abs().max().item() for _, w in want[1:])
        worst_l2 = worst_max = 0.0
        for (n, g), (_, r) in zip(got, want):
            if not torch.isfinite(g).all():
                fail(f"{name}: {n} not finite")
            diff = (g - r).abs()
            if n.endswith(zero):
                if not diff.max().item() <= TOL["float32"] * top:
                    fail(f"{name}: {n} differs by {diff.max().item():.3e}")
                continue
            worst_max = max(worst_max, diff.max().item()
                            / max(r.abs().max().item(), 1e-30))
            worst_l2 = max(worst_l2, l2(g, r))
            if not l2(g, r) <= STACK_F32_L2:
                fail(f"{name}: {n} rel L2 err {l2(g, r):.3e}")
        print(f"check {name}: output and {len(got) - 1} gradients, worst "
              f"rel L2 err {worst_l2:.3e} (<= {STACK_F32_L2:.0e}), worst "
              f"max-element rel err {worst_max:.3e}")
        return
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


def train_main_path(cli, counters, engines, tmp):
    """The port's train CLI on cont2cont_mdn for TRAIN_STEPS steps, then
    eval on its checkpoint, each with every launch counter reset just
    before and read just after. Returns (train launches, steps)."""
    import torch

    run = os.path.join(tmp, "run")
    argv = ["train", "--preset", "cont2cont_mdn", "--run-dir", run,
            "--device", "cuda", "--notifier", "none",
            "--loop-arg", f"total_steps={TRAIN_STEPS}",
            "--loop-arg", "log_every=1", "--loop-arg", "eval_every=1000",
            "--loop-arg", f"save_every={TRAIN_STEPS}"]
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
    for k in STACK_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by cli train")
    composed = sorted(s for s in engines._seen
                      if s[0] in ("encoder-stack", "decoder-stack")
                      and s[1] == "composed")
    if composed:
        fail(f"a stack declined its kernels: {composed}")
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
    for k in ("linear", "layernorm_rows", "encoder_attention",
              "attention_fwd"):
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
    model.encoder.attn_impl = model.decoder.attn_impl = "xla"
    p_ev = evaluate(make_eval_step(model), batches)
    rel = abs(k_ev["loss"] - p_ev["loss"]) / abs(p_ev["loss"])
    print(f"check eval loss, kernels {k_ev['loss']:.5f} vs composed "
          f"{p_ev['loss']:.5f} (2 batches): rel {rel:.3e} (tol "
          f"{TOL['bfloat16']:.0e})")
    if not rel <= TOL["bfloat16"]:
        fail("the kernels' eval loss differs from the composed model's")
    return launches, TRAIN_STEPS


def profile_steps(label, step, batch, gpu, step_ms, n=2, top=12):
    """torch.profiler over ``n`` train steps: the device's busy time per
    step, its idle share against the untraced step time ``step_ms`` (the
    tracer slows the host, so the traced window's wall time overstates
    it), and the kernels with the most device time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):   # the tracer's set-up
        step(batch)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: a host op's "self device time" also
        # holds the kernels launched under it without an op of their own
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    print(f"profile train step {label} ({n} steps under torch.profiler): "
          f"device busy {busy / n:.2f} ms/step, idle share "
          f"{1 - busy / n / step_ms:.3f} of the untraced p50 {step_ms:.2f} "
          f"ms (traced wall {wall / n:.2f} ms/step) [{gpu}]")
    for dev_ms, count, key in rows[:top]:
        print(f"  {dev_ms / n:8.3f} ms/step {count // n:6d} calls/step  "
              f"{key[:90]}")


def train_step_times(gpu, dev, cli):
    """Train step ms and sketches/s (host clock around synchronised steps)
    at the cont2cont_mdn and the cont_train shape (the stacks' dropout in
    'prng' mode, and cont_train again with the stacks forced to 'bits', PR
    3's mode, for the comparison) and at the JAX benchmark's token cells
    train (H=2) and train_h8 (H=8); returns them."""
    import torch

    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.convert import init_params
    from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.presets import get_preset
    from sketchformer_tpu_torch.train.step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    out = {}
    cont = {**get_preset("cont2cont_mdn").model_overrides, "num_classes": 32}
    cont_train = dict(cont, num_heads=2, qk_norm=False, max_len=96,
                      num_classes=345)
    tok = dict(vocab_size=TRAIN["V"], num_classes=TRAIN["classes"],
               max_len=TRAIN["T"], d_model=TRAIN["d"],
               num_layers=TRAIN["L"], num_heads=TRAIN["H"],
               dff=TRAIN["dff"], dropout=0.1, lowerdim=256,
               dtype="bfloat16", attn_impl="pallas", qk_norm=False)
    resolve = dp.resolve_impl
    for label, shape, over, impl in (
            ("cont2cont_mdn", MDN, cont, "auto"),
            ("cont_train", CONT_TRAIN, cont_train, "auto"),
            ("cont_train (stacks in bits mode)", CONT_TRAIN, cont_train,
             "bits"),
            ("train", TRAIN, tok, "auto"),
            ("train_h8", TRAIN, dict(tok, num_heads=8), "auto")):
        B, T = shape["B"], shape["T"]
        cfg = SketchformerConfig(**over)
        model = Sketchformer(cfg)
        model.load_state_dict(init_params(cfg, 0))
        model.to(dev)
        token = not cfg.use_continuous
        loader = get_dataloader_by_name("synthetic")(
            num_classes=cfg.num_classes if token else 32,
            sketches_per_epoch=B * 2, batch_size=B, buckets=(T,),
            token_mode=token)
        batch = batch_to_device(next(loader.batch_iterator("train")), dev)
        state = create_train_state(model, 0, 500, 2.0)
        step = make_train_step(state)
        if impl == "bits":
            dp.resolve_impl = lambda *_: "bits"
        try:
            for _ in range(2):
                step(batch)
            torch.cuda.synchronize()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(ts))
            if not np.isfinite(m["loss"].item()):
                fail(f"{label} train step loss not finite")
            profile_steps(label, step, batch, gpu, ms)
        finally:
            dp.resolve_impl = resolve
        out[label] = (ms, B / ms * 1e3)
        print(f"time train step {label} ({'token' if token else 'MDN'}, "
              f"B={B}, T={T}, d={cfg.d_model}, L={cfg.num_layers}, "
              f"H={cfg.num_heads}, qk_norm={cfg.qk_norm}, {cfg.dtype}, "
              f"dropout {cfg.dropout}): p50 {ms:.2f} ms (min {min(ts):.2f}, "
              f"max {max(ts):.2f}, 5 steps), {B / ms * 1e3:.1f} sketches/s "
              f"[{gpu}]")
        del model, state, step
        torch.cuda.empty_cache()
    return out


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


def check_dropout_prng(dev, errs):
    """K7: the emit kernel bit-equal to the plain Philox at the train
    shape's (2L, B, T, d) with the kept share within 1e-3 of 1 - 26/256;
    then each 'prng' train stack (L=2, cont2cont_mdn width: B=64, T=192,
    H=8, qk-norm; f32 and bf16) equal to the 'bits' stack fed the emitted
    bytes, output and every gradient (torch.equal)."""
    import torch

    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import encoder_stack_train as est

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


def train_tok_main_path(cli, counters, engines, tmp):
    """The port's train CLI on pretrain_full (token mode) for TRAIN_STEPS
    steps from a synthetic 345-class token loader, then eval on its
    checkpoint, each with every launch counter reset just before and read
    just after. Returns the train launches."""
    import dataclasses

    import torch

    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.ops import encoder_stack_train as est
    from sketchformer_tpu_torch.train.loop import evaluate
    from sketchformer_tpu_torch.train.step import make_eval_step

    run = os.path.join(tmp, "run_tok")
    argv = ["train", "--preset", "pretrain_full", "--loader", "synthetic",
            "--loader-arg", "num_classes=345", "--loader-arg",
            "sketches_per_epoch=8280", "--run-dir", run, "--device", "cuda",
            "--notifier", "none", "--loop-arg", f"total_steps={TRAIN_STEPS}",
            "--loop-arg", "warmup_steps=500", "--loop-arg", "log_every=1",
            "--loop-arg", "eval_every=1000", "--loop-arg",
            f"save_every={TRAIN_STEPS}"]
    print("main path: python -m sketchformer_tpu_torch.cli " + " ".join(argv))
    print("  cuts: the preset's QuickDraw shards are not in the repo, so its "
          "loader is the synthetic token loader of 345 classes (the preset's "
          "batch 256 and buckets 64/96/128/192 kept); warmup 10,000 -> 500 so "
          f"that the loss can move in {TRAIN_STEPS} steps; {TRAIN_STEPS} of "
          "300,000 steps")
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
    for k in STACK_KERNELS + TOK_KERNELS + ("prng_draw",):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by cli train (token)")
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


def device_ms(fn, names, n=3):
    """Device time per call of each kernel whose name holds one of
    ``names``, from a torch.profiler trace of ``n`` calls of ``fn``."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        for k in names:
            if k in e.key:
                out[k] += us / 1e3 / n
    return out


def token_ce_times(randn, gen, dev, gpu, cuda_ms, paired):
    """K6 at the train shape (bf16, M 49,152, d 256, V 10,004): each kernel
    against its plain version and one PyTorch call of its product. The
    backward wrapper launches both backward kernels; each one's time is its
    device time in a profiler trace of the wrapper, and both rows carry the
    plain backward's time (it computes dx, dW and db together). Returns
    {kernel: (ms, plain_ms, library_ms)}."""
    import torch

    from sketchformer_tpu_torch.ops import token_ce as tce

    M, d, V = TRAIN["B"] * TRAIN["T"], TRAIN["d"], TRAIN["V"]
    dt = torch.bfloat16
    x, w, b, tgt, gll = ce_operands(randn, gen, dev, M, d, V, dt)
    wd = w.to(dt)
    lse = tce.token_ce_fwd(x, w, b, tgt)[2]
    dl = randn(M, V, scale=1e-3, dtype=dt)
    out = {}
    with torch.no_grad():
        k_ms, p_ms = paired(lambda: tce.token_ce_fwd(x, w, b, tgt),
                            lambda: tce.token_ce_fwd_reference(x, w, b, tgt),
                            iters=5, warm=1)
        out["token_ce_fwd"] = (k_ms, p_ms, cuda_ms(
            lambda: torch.addmm(b.to(dt), x, wd), 5, 1))
        k_ms, p_ms = paired(
            lambda: tce.token_ce_bwd(x, w, b, tgt, lse, gll),
            lambda: tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll),
            iters=3, warm=1)
        parts = device_ms(lambda: tce.token_ce_bwd(x, w, b, tgt, lse, gll),
                          ("ce_dx_kernel", "ce_dw_kernel"))
        print(f"time token_ce_bwd (bf16, M={M}, d={d}, V={V}, the wrapper: "
              f"both kernels and the partial sums): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms; device time ce_dx_kernel "
              f"{parts['ce_dx_kernel']:.4f} ms, ce_dw_kernel "
              f"{parts['ce_dw_kernel']:.4f} ms [{gpu}]")
        out["token_ce_dx"] = (parts["ce_dx_kernel"], p_ms, cuda_ms(
            lambda: torch.matmul(dl, wd.t()), 5, 1))
        out["token_ce_dw"] = (parts["ce_dw_kernel"], p_ms, cuda_ms(
            lambda: torch.matmul(x.t(), dl), 5, 1))
    for name, (k_ms, p_ms, l_ms) in out.items():
        print(f"time {name} (bf16, M={M}, d={d}, V={V}): kernel {k_ms:.4f} "
              f"ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms [{gpu}]")
    del dl, x
    torch.cuda.empty_cache()
    return out


def emit_times(dev, gpu, cuda_ms, paired):
    """The emit kernel at the train shape's (2L, B, T, d) against the plain
    Philox. Returns (ms, plain_ms)."""
    from sketchformer_tpu_torch.ops import dropout_prng as dp

    L, B, T, d = TRAIN["L"], TRAIN["B"], TRAIN["T"], TRAIN["d"]
    k_ms, p_ms = paired(
        lambda: dp.emit_dropout_bits(PRNG_SEED, L, 2, B, T, d, dev),
        lambda: dp.emit_dropout_bits_reference(PRNG_SEED, L, 2, B, T, d, dev),
        iters=5, warm=1)
    print(f"time emit_dropout_bits ((2L, B, T, d) = ({2 * L}, {B}, {T}, {d}))"
          f": kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{gpu}]")
    return k_ms, p_ms


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work
# ---------------------------------------------------------------------------

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core rate, FLOP/s
PEAK_F32 = 67e12        # float32 outside the tensor cores
HBM = 3.35e12           # bytes/s


def bound(flops, nbytes, dtype_bytes=2):
    """(ms, 'operations' | 'bytes'): the larger of the two times."""
    peak = PEAK_BF16 if dtype_bytes == 2 else PEAK_F32
    t_op, t_by = flops / peak, nbytes / HBM
    return (max(t_op, t_by) * 1e3,
            "operations" if t_op >= t_by else "bytes")


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
    tn = gemm_work([(dff, M, d, 2, 2, 4, u8), (d, M, dff, 2, 4, 4, 0),
                    (d, M, d, 2, 4, 4, u8), (d, M, 3 * HD, 2, 4, 4, 0)])
    qkv = 3 * M * HD * 2
    att = 4 * B * H * T * T * Dh
    return {
        "linear_nt": nt, "linear_tn": tn,
        "attention_fwd": (att, qkv + M * HD * 2 + B * T * 4),
        "attention_bwd_q": (1.5 * att, qkv + 2 * M * HD * 4 + B * H * T * 12),
        "attention_bwd_kv": (2 * att, qkv + 3 * M * HD * 4 + B * H * T * 12),
        "layernorm_bwd": (10 * M * d, M * d * (2 + 4 + 2 + 4) + 4 * d * 4),
        "sum_rows": (M * 3 * HD, M * 3 * HD * 4 + 3 * HD * 4),
    }


def serving_kernel_work(B, T, d, H, dff, L, V, K, N_mdn):
    """{kernel: (flops, bytes)} of the timed calls of the serving kernels
    (bf16): linear = one encoder layer's 4 products; encoder_attention and
    layernorm_rows one call at (B, T); decode chunks the mean 16-step chunk
    of a T=192 decode (cache positions t0 + 16, t0 = 88 on average);
    decode_attention one call (B*H, cache_len T/2)."""
    M, Dh = B * T, d // H
    lin = gemm_work([(M, d, 3 * d, 2, 2, 2, 0), (M, d, d, 2, 2, 2, M * d * 2),
                     (M, d, dff, 2, 2, 2, 0), (M, dff, d, 2, 2, 2, M * d * 2)])
    trunk_w = L * (d * 3 * d + 3 * d * d + 2 * d * dff) * 2
    t_mean = 88 + K
    per_row = L * 2 * (d * 3 * d + 3 * d * d + 2 * d * dff) + L * 4 * t_mean * d

    def chunk(N, emb):
        fl = K * B * (per_row + 2 * d * N)
        by = (trunk_w + d * N * 2 + emb + 2 * L * B * H * t_mean * Dh * 2
              + 2 * L * B * H * 4 * Dh * 2 + K * B * 8)
        return fl, by
    n = T // 2
    return {
        "linear": lin,
        "encoder_attention": (4 * B * H * T * T * Dh,
                              3 * M * d * 2 + M * d * 2 + B * T * 4),
        "layernorm_rows": (8 * M * d, 2 * M * d * 2 + 2 * d * 4),
        "decode_chunk": chunk(V, V * d * 2),
        "decode_cont_chunk": chunk(N_mdn, 5 * d * 2),
        "decode_attention": (4 * B * H * n * Dh,
                             (2 * B * H * Dh + 2 * B * H * n * Dh) * 2),
    }


def token_kernel_work(M, d, V, L):
    """{kernel: (flops, bytes)} of K6 and K7 at the train shape: the CE
    forward (2 M d V), the backward as the TPU kernel does it (one logits
    recompute and the dx and dW products, 6 M d V) split into dx (the
    recompute and dx) and dW (its product; ce_dw's own recompute is work
    the TPU design does not do); emit writes (2L, B*T, d) bytes."""
    x, wb = M * d * 2, d * V * 2 + V * 4
    return {
        "token_ce_fwd": (2 * M * d * V, x + wb + M * 4 + 3 * M * 4),
        "token_ce_dx": (4 * M * d * V, x + wb + 3 * M * 4 + M * d * 2),
        "token_ce_dw": (2 * M * d * V, x + wb + 3 * M * 4 + d * V * 4
                        + V * 4),
        "emit_dropout_bits": (0, 2 * L * M * d),
    }


def train_kernel_times(randn, dev, gpu, cuda_ms, paired):
    """Each training kernel (the layer's call set) against its plain version
    and, where one PyTorch call computes the same function, that call; bf16
    at the cont2cont_mdn layer. Returns {kernel: (ms, plain_ms, lib_ms)}."""
    import torch
    import torch.nn.functional as F

    from sketchformer_tpu_torch.ops import encoder_stack as es
    from sketchformer_tpu_torch.ops import norm_train as nt

    B, T, d, H, dff = (MDN[k] for k in ("B", "T", "d", "H", "dff"))
    dt = torch.bfloat16
    o = train_operands(randn, dev, B=B, T=T, d=d, H=H, dff=dff, dtype=dt,
                       qk=True)
    out = {}

    def lib_nt():
        for a, w in ((o["g"], o["w2"]), (o["gf"], o["w1"]),
                     (o["g32"], o["wo"]), (o["gqkv"], o["wqkv"])):
            torch.matmul(a.to(dt), w.t())

    def lib_tn():
        for x, y in ((o["f1"], o["g"]), (o["x"], o["gf"]), (o["x"], o["g32"]),
                     (o["x"], o["gqkv"])):
            torch.matmul(x.t(), y.to(dt))

    q4, k4, v4 = (t.reshape(B, T, H, d // H).transpose(1, 2)
                  for t in (o["q"], o["k"], o["v"]))
    mask = (o["bias"] == 0)[:, None, None, :]
    # the SDPA backward at the same shape (no qk-norm): one call computes
    # dq, dk and dv
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    with torch.enable_grad():
        sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    do4 = o["do"].reshape(B, T, H, d // H).transpose(1, 2).to(dt)

    def lib_attn_bwd():
        with torch.enable_grad():
            torch.autograd.grad(sdpa, (qs, ks, vs), do4, retain_graph=True)

    # LayerNorm's backward on the same rows (f32, as the gradient is)
    x32 = o["x"].float()
    _, ln_mean, ln_rstd = torch.ops.aten.native_layer_norm(
        x32, [d], o["scale"], o["bvec"], 1e-6)

    def lib_ln_bwd():
        torch.ops.aten.native_layer_norm_backward(
            o["g32"], x32, [d], ln_mean, ln_rstd, o["scale"], o["bvec"],
            [True, True, True])

    with torch.no_grad():
        for name, kern, plain, lib in (
                ("linear_nt", layer_nt_calls(o, es.linear_nt),
                 layer_nt_calls(o, es.linear_nt_reference), lib_nt),
                ("linear_tn", layer_tn_calls(o, es.linear_tn),
                 layer_tn_calls(o, es.linear_tn_reference), lib_tn),
                ("attention_fwd", attn_calls(o, H, True, "fwd", "kernel"),
                 attn_calls(o, H, True, "fwd", "plain"),
                 lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                        attn_mask=mask)),
                ("attention_bwd_q", attn_calls(o, H, True, "bwd_q", "kernel"),
                 attn_calls(o, H, True, "bwd_q", "plain"), lib_attn_bwd),
                ("attention_bwd_kv", attn_calls(o, H, True, "bwd_kv",
                                                "kernel"),
                 attn_calls(o, H, True, "bwd_kv", "plain"), lib_attn_bwd),
                ("layernorm_bwd",
                 lambda: nt.layernorm_bwd(o["x"], o["g32"], o["scale"],
                                          resid=o["g"]),
                 lambda: nt.layernorm_bwd_reference(o["x"], o["g32"],
                                                    o["scale"], resid=o["g"]),
                 lib_ln_bwd),
                ("sum_rows", lambda: nt.sum_rows(o["gqkv"]),
                 lambda: nt.sum_rows_reference(o["gqkv"]),
                 lambda: torch.sum(o["gqkv"], dim=0))):
            k_ms, p_ms = paired(kern, plain, iters=10, warm=2)
            lib_ms = cuda_ms(lib, 10, 2) if lib is not None else None
            out[name] = (k_ms, p_ms, lib_ms)
            print(f"time {name} (bf16, B={B}, T={T}, d={d}, H={H}, "
                  f"dff={dff}{', the layer: 4 calls' if 'linear' in name else ''}"
                  f"): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} [{gpu}]")
    return out


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


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sketchformer_tpu_torch import cli
    from sketchformer_tpu_torch.infer import decode as dec
    from sketchformer_tpu_torch.infer.encode import embed_dataset
    from sketchformer_tpu_torch.infer.fast_decode import decoder_operands
    from sketchformer_tpu_torch.infer.fast_encode import fast_embed
    from sketchformer_tpu_torch.ops import _build
    from sketchformer_tpu_torch.ops import decode_attention as da
    from sketchformer_tpu_torch.ops import decode_chunk as dc
    from sketchformer_tpu_torch.ops import attention_train as at
    from sketchformer_tpu_torch.ops import encoder_stack as es
    from sketchformer_tpu_torch.ops import dropout_prng as dp
    from sketchformer_tpu_torch.ops import norm_train as nt
    from sketchformer_tpu_torch.ops import token_ce as tce
    from sketchformer_tpu_torch.utils import engines

    counters = (es, dc, da, at, nt, tce, dp)

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
    print(f"build: {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()

    # ---- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

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
        for rows, D in ((M, d), (1000, 100)):
            xr = x if rows == M else randn(rows, D, dtype=dtype)
            s, bb = ln_params(D)
            compare(f"layernorm_rows {tag} M={rows} D={D}",
                    es.layernorm_rows(xr, s, bb),
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
    check_train_kernels(randn, dev, errs, compare)
    check_token_ce(randn, gen, dev, errs, compare)
    check_dropout_prng(dev, errs)

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
        for name in ("linear", "encoder_attention", "layernorm_rows"):
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the main path")
        if launches["linear_nt"] or launches["linear_tn"]:
            fail("the sbir path launched a backward kernel")
        if dc.LAUNCHES["decode_chunk"] or da.LAUNCHES["decode_attention"]:
            fail("the sbir path launched a decode kernel")
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
    enc = torch.from_numpy(batches[0]["enc"]).to(dev)
    with torch.inference_mode():
        weights = model.encoder.stacked_weights()
        z_kernel = fast_embed(model, enc, None, weights)
        km = model.enc_key_mask(enc, None)
        enc_out = es.encoder_stack_reference(
            model.embed_input(enc), km, weights, num_heads=cfg.num_heads,
            qk_norm=cfg.qk_norm)
        z_plain = model.bottleneck.pooled_z(enc_out, km).float()
    compare("main-path z, kernel vs plain (one batch of 64)", z_kernel,
            z_plain, cfg.compute_dtype)

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
        for k in needs:
            if got[k] <= 0:
                fail(f"kernel {k} was not launched by cli {' '.join(argv)}")
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

    # ---- 4d. main path: token-mode training, then eval -------------------
    with tempfile.TemporaryDirectory() as tmp:
        tok_launches = train_tok_main_path(cli, counters, engines, tmp)
    for k in TOK_KERNELS:
        launches[k] = tok_launches[k]

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

    import torch.nn.functional as F

    dt = cfg.compute_dtype
    times = {}
    lib = {}    # one PyTorch call computing the same function, where one does
    B = 64
    M = B * T
    w = weights
    x = randn(M, d, dtype=dt)
    hid = torch.relu(randn(M, dff, dtype=dt))

    def layer_linears(fn):
        def run():
            fn(x, w["wqkv"][0], w["bqkv"][0])
            fn(x, w["wo"][0], w["bo"][0], residual=x)
            fn(x, w["w1"][0], w["b1"][0], relu=True)
            fn(hid, w["w2"][0], w["b2"][0], residual=x)
        return run

    with torch.inference_mode():
        times["linear"] = paired(layer_linears(es.linear),
                                 layer_linears(es.linear_reference))
        qkv = randn(B, T, 3 * d, dtype=dt)
        kbias = torch.where(key_mask(B, T), 0.0, es.NEG_INF).float()
        times["encoder_attention"] = paired(
            lambda: es.encoder_attention(qkv, kbias, num_heads=H),
            lambda: es.attention_reference(qkv, kbias, num_heads=H))
        times["layernorm_rows"] = paired(
            lambda: es.layernorm_rows(x, w["lnfs"][0], w["lnfb"][0]),
            lambda: es.layernorm_rows_reference(x, w["lnfs"][0],
                                                w["lnfb"][0]))
        Dh = d // H
        q4, k4, v4 = (t.reshape(B, T, H, Dh).transpose(1, 2)
                      for t in qkv.split(d, dim=-1))
        amask = (kbias == 0)[:, None, None, :]
        lib["linear"] = cuda_ms(lambda: [
            torch.addmm(w[b][0].to(dt), a, w[k][0])
            for a, k, b in ((x, "wqkv", "bqkv"), (x, "wo", "bo"),
                            (x, "w1", "b1"), (hid, "w2", "b2"))])
        lib["encoder_attention"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=amask))
        lib["layernorm_rows"] = cuda_ms(
            lambda: F.layer_norm(x, (d,), w["lnfs"][0].to(dt),
                                 w["lnfb"][0].to(dt), 1e-6))
        for name, (k_ms, p_ms) in times.items():
            print(f"library {name}: {lib[name]:.4f} ms [{gpu}]")
            print(f"time {name} (B={B}, T={T}, {str(dt)[6:]}"
                  f"{', one layer: 4 calls' if name == 'linear' else ''})"
                  f": kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{gpu}]")
        for Bs in (64, 512):
            xs = randn(Bs, T, d, dtype=dt)
            km = key_mask(Bs, T)
            k_ms, p_ms = paired(
                lambda: es.fused_encoder_stack(xs, km, weights, num_heads=H),
                lambda: es.encoder_stack_reference(xs, km, weights,
                                                   num_heads=H),
                iters=10)
            print(f"time fused_encoder_stack (L={L}, B={Bs}, T={T}, d={d}, "
                  f"H={H}, {str(dt)[6:]}): kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, kernel {Bs / k_ms * 1e3:.0f} sketches/s "
                  f"[{gpu}]")

    embed_dataset(model, batches[:2])       # warm-up
    t0 = time.perf_counter()
    Z2, _ = embed_dataset(model, batches)
    e2e_s = time.perf_counter() - t0
    print(f"time embed_dataset end to end ({len(batches)} batches of 64, "
          f"bucket {T}): {len(Z2) / e2e_s:.1f} sketches/s "
          f"({e2e_s * 1e3:.2f} ms) [{gpu}]")

    # decode: per chunk (the mean over a T=192 decode's 12 chunks) and per
    # decode_attention call, kernel vs plain; then whole decodes
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
        kc = torch.zeros((cfg.num_layers, B * H, T, cfg.d_model // H),
                         dtype=cfg.compute_dtype, device=dev)
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
        cfg, ops, ck, cv, kc, vc, pos = chunk_state(model, enc64)

        def token_chunks(fn):
            def run():
                prev = torch.full((B,), SOS_ID, dtype=torch.int32, device=dev)
                fin = torch.zeros((B,), dtype=torch.int32, device=dev)
                for t in range(0, T, K):
                    ids, fin = fn(prev, fin, kc, vc, ck, cv, ops["emb"],
                                  pos[t:t + K], ops["head_w"], ops["head_b"],
                                  ops["w"], t, num_heads=H,
                                  qk_norm=cfg.qk_norm, pad_id=PAD_ID,
                                  sos_id=SOS_ID, eos_id=EOS_ID)
                    prev = ids[:, -1].contiguous()
            return run

        k_ms, p_ms = paired(token_chunks(dc.decode_chunk),
                            token_chunks(dc.decode_chunk_reference),
                            iters=2, warm=1)
        times["decode_chunk"] = (k_ms / nchunks, p_ms / nchunks)

        mdn, mloader = preset_model("cont2cont_mdn")
        mb = mloader.get_validation_set(max_batches=1)[0]
        mcfg, mops, mck, mcv, mkc, mvc, mpos = chunk_state(
            mdn, torch.from_numpy(mb["enc"]).to(dev),
            torch.from_numpy(mb["enc_mask"]).to(dev))

        def mdn_chunks(fn):
            def run():
                row = torch.zeros((B, 5), device=dev)
                row[:, 3] = 1.0
                fin = torch.zeros((B,), dtype=torch.int32, device=dev)
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

        k_ms, p_ms = paired(mdn_chunks(dc.decode_cont_chunk),
                            mdn_chunks(dc.decode_cont_chunk_reference),
                            iters=2, warm=1)
        times["decode_cont_chunk"] = (k_ms / nchunks, p_ms / nchunks)
        del mdn

        Dh = cfg.d_model // H
        q = randn(B * H, 1, Dh, dtype=dt)
        kq, vq = (randn(B * H, T, Dh, dtype=dt) for _ in range(2))
        times["decode_attention"] = paired(
            lambda: da.decode_attention(q, kq, vq, T // 2),
            lambda: da.decode_attention_reference(q, kq, vq, T // 2),
            iters=50)
        lib["decode_attention"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q, kq[:, :T // 2], vq[:, :T // 2]), iters=50)
    for name in ("decode_chunk", "decode_cont_chunk"):
        k_ms, p_ms = times[name]
        print(f"time {name} (B={B}, L={cfg.num_layers}, d={cfg.d_model}, "
              f"H={H}, K={K}, {str(dt)[6:]}, per chunk, mean of the "
              f"{nchunks} chunks of T={T}): kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms [{gpu}]")
    k_ms, p_ms = times["decode_attention"]
    print(f"time decode_attention (B*H={B * H}, Dh={Dh}, Tmax={T}, "
          f"cache_len={T // 2}, {str(dt)[6:]}, per call): kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library (SDPA) "
          f"{lib['decode_attention']:.4f} ms [{gpu}]")

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for label, decoder, reps in (
            ("chunk engine (decode_chunk)", dec.make_token_decoder(model), 7),
            ("composed (decode_attention)",
             dec.make_token_decoder(model, fast=False), 3)):
        ended = int((decoder(enc64) == EOS_ID).any(1).sum())
        ts = host_ms(lambda: decoder(enc64), reps)
        big = host_ms(lambda: decoder(enc512), 2)
        print(f"time decode ar_decode {label}, T={T}, {ended} of 64 rows "
              f"reach EOS: "
              f"B=64 p50 {float(np.median(ts)):.2f} ms (min {min(ts):.2f}, "
              f"max {max(ts):.2f}, {reps} runs); B=512 "
              f"{512 / float(np.median(big)) * 1e3:.1f} sketches/s "
              f"({float(np.median(big)):.1f} ms) [{gpu}]")

    # the training kernels, the stacks and whole train steps
    for name, (k_ms, p_ms, l_ms) in train_kernel_times(
            randn, dev, gpu, cuda_ms, paired).items():
        times[name] = (k_ms, p_ms)
        lib[name] = l_ms
    stack_times(dev, gpu, cuda_ms)
    for name, (k_ms, p_ms, l_ms) in token_ce_times(
            randn, gen, dev, gpu, cuda_ms, paired).items():
        times[name] = (k_ms, p_ms)
        lib[name] = l_ms
    times["emit_dropout_bits"] = emit_times(dev, gpu, cuda_ms, paired)
    lib["emit_dropout_bits"] = None
    steps_ms = train_step_times(gpu, dev, cli)
    print(f"train steps: {json.dumps(steps_ms)} [{gpu}]")

    work = serving_kernel_work(B=64, T=SBIR["T"], d=SBIR["d"], H=SBIR["H"],
                               dff=SBIR["dff"], L=SBIR["L"], V=AR["V"],
                               K=AR["K"], N_mdn=6 * MDN_MIXTURES + 3)
    work.update(train_kernel_work(*(MDN[k] for k in ("B", "T", "d", "H",
                                                     "dff"))))
    work.update(token_kernel_work(TRAIN["B"] * TRAIN["T"], TRAIN["d"],
                                  TRAIN["V"], TRAIN["L"]))

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
