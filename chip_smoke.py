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
   those steps;
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
   the decoded prefix;
5. times: kernel vs plain (CUDA events after warm-up), the end-to-end
   embed rate, per-chunk and per-call decode kernel times, and the
   whole-decode p50 at B=64/T=192 and sketches/s at B=512 for the chunk
   engine and the composed decoder, each with the card's name and power
   limit.

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
           "decode_attention": "decode_attention.cu"}
REPLACES = {
    "linear": "sketchformer_tpu/ops/pallas_encoder.py:140",
    "encoder_attention": "sketchformer_tpu/ops/pallas_packed.py:169",
    "layernorm_rows": "sketchformer_tpu/ops/pallas_encoder.py:63",
    "decode_chunk": "sketchformer_tpu/ops/pallas_decode_packed.py:455",
    "decode_cont_chunk": "sketchformer_tpu/ops/pallas_decode_packed.py:549",
    "decode_attention": "sketchformer_tpu/ops/pallas_decode.py:73",
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

    from sketchformer_tpu.data.pipeline import PEN_END
    from sketchformer_tpu.data.tokenizer import EOS_ID
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

    from sketchformer_tpu.data.pipeline import PEN_END
    from sketchformer_tpu.data.tokenizer import EOS_ID, PAD_ID, SOS_ID
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
    from sketchformer_tpu_torch.ops import encoder_stack as es

    counters = (es, dc, da)

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

    def compare(name, got, ref, dtype, record=None):
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            fail(f"{name}: kernel output not finite")
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
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
        for name, n in launches.items():
            if n <= 0:
                fail(f"kernel {name} was not launched by the main path")
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
        for name, (k_ms, p_ms) in times.items():
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
    from sketchformer_tpu.data.pipeline import PEN_END
    from sketchformer_tpu.data.tokenizer import EOS_ID, PAD_ID, SOS_ID

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
    for name in ("decode_chunk", "decode_cont_chunk"):
        k_ms, p_ms = times[name]
        print(f"time {name} (B={B}, L={cfg.num_layers}, d={cfg.d_model}, "
              f"H={H}, K={K}, {str(dt)[6:]}, per chunk, mean of the "
              f"{nchunks} chunks of T={T}): kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms [{gpu}]")
    k_ms, p_ms = times["decode_attention"]
    print(f"time decode_attention (B*H={B * H}, Dh={Dh}, Tmax={T}, "
          f"cache_len={T // 2}, {str(dt)[6:]}, per call): kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms [{gpu}]")

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

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "jaxlib"))
    if leaked:
        fail(f"JAX was imported: {leaked[:5]}")

    kernels = [{
        "name": name, "route": "cuda", "source": CSRC + SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": times[name][0],
        "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
