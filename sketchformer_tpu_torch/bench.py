"""The benchmark: the north-star sections of the repo-root ``bench.py`` on
the card, through the port's own entry points.

    python -m sketchformer_tpu_torch.cli bench [--device cuda]
    python -m sketchformer_tpu_torch.bench [--device cuda]

Sections, in the JAX benchmark's order and under its names (flagship
token model: d 256, 8 layers, 2 heads of 128, dff 512, lowerdim 256,
vocab 10,004, 345 classes, dropout 0.1, bf16 on the card; seeded random
weights from ``convert.init_params(cfg, 0)``, inputs from
``np.random.default_rng(0)`` drawn in the JAX benchmark's order):

- headline encode (always runs): sketches/s of ``fast_embed`` at T=96,
  B=2048 as the marginal cost of one forward: N back-to-back calls, each
  input depending on the last output, synchronised once at the end on a
  scalar read; ``per_fwd = (t(N2) - t(N1)) / (N2 - N1)``, the best of 3
  for each N (N1=4, N2=24, timed in turns), so the host's dispatch and the
  read cancel;
  ``mfu_encode`` is the trunk's FLOPs at that rate over the H100's dense
  bf16 peak (``timing.PEAK_BF16``);
- ``train``: sketches/s of n back-to-back ``make_train_step`` steps at
  B=512 (``n = max(iters * TB // B, 4)``) on one pre-built device batch,
  with one read of the last loss;
- ``decode``: p50 ms of greedy ``make_token_decoder`` reconstructions of
  64 sketches at T=192 (host clock around a call whose ids are copied to
  the host, 10 runs) and sketches/s at B=512 (5 runs);
- ``h8_train``, ``h8_encode`` (T=96 and 192), ``h8_decode``: the same at 8
  heads of 32; ``t192_encode``: encode at T=192; ``cont``: encode, greedy
  MDN decode and train of the 20-mixture continuous model; ``b1024_train``:
  train at B=1024;
- ``embed_pipeline`` and ``decode_realistic``: the two tools of
  ``sketchformer_tpu_torch/tools/`` (``bench_embed_pipeline``,
  ``bench_decode_realistic``), each ``measure``d in this process, once.

Before its timed calls each section holds its output once against the
plain route (``utils/checks.py``): z against the plain encoder stack, each
decode batch size against the float32 teacher-forced forward of its own
picks, and a forward and backward at dropout 0 (loss and every gradient
leaf) against the composed float32 model's autograd on the same batch; on
the card each checked call must also have launched the section's kernels
(and a bf16 decode chunk only the cluster kernel). A failed check fails
the section: a wrong kernel is not timed.

stdout carries only JSON lines: after every section, one complete
cumulative result line (``metric``, ``value``, ``unit``, ``extras``), so a
run cut at any point leaves a whole artifact; notes and the checks' lines
go to stderr. ``SKETCHFORMER_BENCH_BUDGET_S`` (default 1500) is the
seconds the sections may take: a section runs when its estimate
(:func:`sections`) and those of the sections run before it fit in the
budget; the first that does not fit and every later one are named in
``extras["skipped"]``. So a budget yields a prefix of the order, the same
one on every card and host, and the run keeps to it on a card at least
half as fast as the estimates'. (The JAX benchmark counts the clock and
goes on to try each later section; with the card's sections of a few
seconds, which of them a budget yielded would hang on the clock.) A
section that raises is recorded as ``"<name>_error"``, the run goes on,
and :func:`main` returns 1. On the CPU (``--device cpu``) the sizes are
the JAX benchmark's CPU sizes, in float32 on the plain routes, and only
the headline, ``train`` and ``decode`` run; the rates are the CPU's and ``mfu_encode`` is None.
Nothing falls back to the CPU when ``cuda`` was asked for.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.utils import checks, timing

BUDGET_ENV = "SKETCHFORMER_BENCH_BUDGET_S"
DEFAULT_BUDGET_S = 1500.0
# keys of the JAX benchmark's result line left out: a ratio to a TPU
# target, a note citing a TPU figure, the remote link's round trips, the
# JAX backend's name, and the bookkeeping of its tools' fresh-subprocess
# retries, which are not ported
DROPPED_KEYS = ("vs_baseline", "mfu_encode_note", "link_rtt_ms", "backend",
                "embed_pipeline_attempts", "decode_realistic_attempts",
                "decode_realistic_degraded")
# keys added: the card's name and power limit (nvidia-smi), the torch,
# CUDA and nvcc versions, the device the run measured, the kernels' build
# seconds and each section's seconds
ADDED_KEYS = ("gpu", "torch", "cuda", "nvcc", "device", "build_s",
              "section_s")
# the kernels a checked train step must launch on the card
TRAIN_KERNELS = ("linear", "linear_nt", "linear_tn", "attention_fwd",
                 "attention_bwd_q", "attention_bwd_kv", "layernorm_bwd")
TOKEN_CE_KERNELS = ("token_ce_fwd", "token_ce_dx", "token_ce_dw")


def embed_flops_per_sketch(cfg: SketchformerConfig, T: int) -> int:
    """Encoder forward FLOPs per sketch at length T: the trunk's products
    and attention (embeddings, LayerNorm and the bottleneck left out, so
    an MFU from it is conservative)."""
    d, dff, L = cfg.d_model, cfg.dff, cfg.num_layers
    trunk = 2 * T * L * (4 * d * d + 2 * d * dff)
    attn = 2 * 2 * T * T * d * L
    return trunk + attn


def note(run, msg: str) -> None:
    print(f"[bench {run.elapsed():6.1f}s] {msg}", file=sys.stderr,
          flush=True)


class Run:
    """One benchmark run: its device, sizes, base config, inputs, clock,
    result line and the seeded weights of each config it built."""

    def __init__(self, device: torch.device, budget_s: float, out) -> None:
        self.dev = device
        self.on_card = device.type == "cuda"
        self.budget_s = budget_s
        self.out = out
        on = self.on_card
        # the JAX benchmark's sizes (bench.py:251-254, :360-361)
        self.SEQ = 96
        self.ENC_BATCH = 2048 if on else 64
        self.DEC_BATCH = 64
        self.DEC_LEN = 192 if on else 32
        self.N1, self.N2 = (4, 24) if on else (1, 3)
        self.TB = 512 if on else 32
        self.iters = 20 if on else 2
        self.cfg = SketchformerConfig(
            vocab_size=10004, num_classes=345,
            max_len=max(self.SEQ, self.DEC_LEN), d_model=256, num_layers=8,
            num_heads=2, dff=512, dropout=0.1, lowerdim=256,
            dtype="bfloat16" if on else "float32",
            attn_impl="pallas" if on else "xla")
        self.cfg8 = dataclasses.replace(self.cfg, num_heads=8)
        self.rng = np.random.default_rng(0)
        self.enc = self.tok_batch(self.ENC_BATCH, self.SEQ)
        dec_in = np.roll(self.enc, 1, axis=1)
        dec_in[:, 0] = 1
        TB = self.TB
        self.batch = {
            "enc": self.enc[:TB], "dec_in": dec_in[:TB],
            "dec_tgt": self.enc[:TB],
            "label": self.rng.integers(0, 345, TB).astype(np.int32),
        }
        self.enc_d = self.tok_batch(self.DEC_BATCH, self.DEC_LEN)
        self._params: Dict[SketchformerConfig, dict] = {}
        self.result: dict = {}
        self.t_start = time.monotonic()

    # --- the clock ----------------------------------------------------------

    def elapsed(self) -> float:
        return time.monotonic() - self.t_start

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def emit(self) -> None:
        extras = self.result["extras"]
        extras["bench_elapsed_s"] = round(self.elapsed(), 1)
        print(json.dumps(self.result), file=self.out, flush=True)

    # --- inputs and models ---------------------------------------------------

    def tok_batch(self, B: int, L: int) -> np.ndarray:
        ids = self.rng.integers(4, 10004, size=(B, L)).astype(np.int32)
        ids[:, -8:] = 0
        ids[:, -9] = 2
        return ids

    def to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.dev)

    def model(self, cfg: SketchformerConfig):
        """A fresh ``Sketchformer(cfg)`` on the device, in eval mode, with
        the seeded weights ``init_params(cfg, 0)`` (drawn once a config)."""
        from sketchformer_tpu_torch.convert import init_params
        from sketchformer_tpu_torch.models.sketchformer import Sketchformer

        if cfg not in self._params:
            self._params[cfg] = init_params(cfg, 0)
        model = Sketchformer(cfg)
        model.load_state_dict(self._params[cfg])
        return model.to(self.dev).eval()

    def launched(self, names, fn):
        """``checks.launched``: on the card the kernels in ``names`` ran,
        and a bf16 decode chunk only on the cluster kernel."""
        return checks.launched(
            names, fn, self.on_card,
            cluster_only=self.cfg.compute_dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# shared measurements
# ---------------------------------------------------------------------------


def marginal_encode(run: Run, model, enc: torch.Tensor,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[float, float]:
    """(sketches/s, seconds a forward) of ``fast_embed`` by the marginal
    method (module doc), after ``checks.embed_check`` of the batch."""
    from sketchformer_tpu_torch.infer.fast_encode import (
        fast_embed,
        supports_fast_path,
    )

    weights = (model.encoder.stacked_weights()
               if supports_fast_path(model) else None)
    run.launched(checks.ENCODE_KERNELS, lambda: checks.embed_check(
        f"encode B={enc.shape[0]} T={enc.shape[1]} "
        f"H={model.config.num_heads}", model, enc, mask, weights))

    @torch.inference_mode()
    def chained(N: int) -> float:
        # each input depends on the last output (a zero the device cannot
        # know in advance), so no forward can start before the last ended
        carry = torch.zeros_like(enc[:, :1] if mask is None
                                 else enc[:, :1, :1])
        total = torch.zeros((), dtype=torch.float32, device=enc.device)
        for _ in range(N):
            z = fast_embed(model, enc + carry, mask, weights)
            nxt = z[:, :1] if mask is None else z[:, :1, None]
            carry = (nxt * 1e-20).to(enc.dtype)
            total = total + z.sum()
        return total.item()

    # the best of 3 for each N, the two N in turns, so that a host whose
    # load drifts slows both alike
    Ns = (run.N1, run.N2)
    ts = {N: [] for N in Ns}
    for N in Ns:
        chained(N)
    for _ in range(3):
        for N in Ns:
            t0 = time.perf_counter()
            chained(N)
            ts[N].append(time.perf_counter() - t0)
    per_fwd = (min(ts[run.N2]) - min(ts[run.N1])) / (run.N2 - run.N1)
    if not per_fwd > 0:
        raise checks.CheckFailed(
            f"the marginal forward did not resolve: best of {run.N1} "
            f"{min(ts[run.N1]):.4f} s, of {run.N2} {min(ts[run.N2]):.4f} s")
    return enc.shape[0] / per_fwd, per_fwd


def timed_train(run: Run, cfg: SketchformerConfig, host_batch: dict,
                name: str) -> float:
    """Sketches/s of back-to-back train steps (module doc), after
    ``checks.train_step_check`` and a first step with a finite loss."""
    from sketchformer_tpu_torch.data.packed import unpack_batch
    from sketchformer_tpu_torch.train.step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    model = run.model(cfg)
    B = host_batch["enc"].shape[0]
    batch = batch_to_device(host_batch, run.dev)
    kernels = TRAIN_KERNELS + (() if cfg.use_continuous else TOKEN_CE_KERNELS)
    checks.train_step_check(f"{name} B={B}", model, unpack_batch(batch),
                            kernels, run.on_card)
    # make_optimizer(d_model)'s defaults, as the JAX benchmark's optimizer
    state = create_train_state(model, 0, warmup_steps=4000, peak_scale=1.0)
    step = make_train_step(state)
    loss = run.launched(kernels, lambda: step(batch))["loss"].item()
    if not math.isfinite(loss):
        raise checks.CheckFailed(f"{name} B={B}: first step's loss {loss}")
    n = max(run.iters * run.TB // B, 4)
    if run.on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        m = step(batch)
    m["loss"].item()
    return round(B * n / (time.perf_counter() - t0), 1)


def decode_check(name: str, model, enc, mask, out) -> None:
    """A whole greedy decode held to the float32 teacher-forced forward of
    its own picks (``checks.teacher_forced_check``)."""
    checks.teacher_forced_check(name, checks.plain_f32_copy(model), enc,
                                mask, out, dtype=model.config.compute_dtype)


def host_seconds(fn: Callable[[], object], reps: int) -> List[float]:
    """Host-clock seconds of each of ``reps`` calls of ``fn`` (which
    copies its result to the host)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def checked_token_decoder(run: Run, model, enc, name: str):
    """``make_token_decoder(model, max_len=DEC_LEN)`` after one decode of
    ``enc`` launched ``decode_chunk`` and passed :func:`decode_check`."""
    from sketchformer_tpu_torch.infer import decode as dec

    decode = dec.make_token_decoder(model, max_len=run.DEC_LEN)
    ids = run.launched(("decode_chunk",), lambda: decode(enc))
    decode_check(name, model, enc, None, ids)
    return decode


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------


def sec_headline(run: Run) -> None:
    extras = run.result["extras"]
    model = run.model(run.cfg)
    sk, per_fwd = marginal_encode(run, model, run.to_dev(run.enc))
    run.result["value"] = round(sk, 1)
    extras["encode_ms_per_batch"] = round(per_fwd * 1e3, 3)
    extras["mfu_encode"] = (round(
        sk * embed_flops_per_sketch(run.cfg, run.SEQ) / timing.PEAK_BF16, 3)
        if run.on_card else None)


def sec_train(run: Run) -> None:
    extras = run.result["extras"]
    extras["train_sketches_per_sec"] = timed_train(run, run.cfg, run.batch,
                                                   "train")


def sec_decode(run: Run) -> None:
    extras = run.result["extras"]
    model = run.model(run.cfg)
    enc_d = run.to_dev(run.enc_d)
    decode = checked_token_decoder(run, model, enc_d, "decode")
    lat = host_seconds(lambda: decode(enc_d).cpu(), 10 if run.on_card else 2)
    extras["decode_p50_ms"] = round(float(np.percentile(lat, 50)) * 1e3, 2)
    extras["decode_sketches_per_sec"] = round(
        run.DEC_BATCH / float(np.percentile(lat, 50)), 1)
    if run.on_card:
        BB = 512
        enc_b = run.to_dev(run.tok_batch(BB, run.DEC_LEN))
        ids = run.launched(("decode_chunk",), lambda: decode(enc_b))
        decode_check(f"decode B={BB}", model, enc_b, None, ids)
        t0 = time.perf_counter()
        for _ in range(5):
            decode(enc_b).cpu()
        extras["decode_batch512_sketches_per_sec"] = round(
            5 * BB / (time.perf_counter() - t0), 1)


def sec_h8_train(run: Run) -> None:
    extras = run.result["extras"]
    extras["train_sketches_per_sec_h8"] = timed_train(run, run.cfg8,
                                                      run.batch, "h8_train")


def sec_h8_encode(run: Run) -> None:
    extras = run.result["extras"]
    for T8, tag in ((run.SEQ, "T96"), (192, "T192")):
        cfg = (run.cfg8 if T8 == run.SEQ
               else dataclasses.replace(run.cfg8, max_len=T8))
        e8 = run.to_dev(run.tok_batch(run.ENC_BATCH, T8))
        sk8, _ = marginal_encode(run, run.model(cfg), e8)
        extras[f"encode_{tag}_h8_sketches_per_sec"] = round(sk8, 1)
        run.emit()


def sec_h8_decode(run: Run) -> None:
    extras = run.result["extras"]
    model8 = run.model(run.cfg8)
    enc_d = run.to_dev(run.enc_d)
    decode8 = checked_token_decoder(run, model8, enc_d, "h8_decode")
    lat8 = host_seconds(lambda: decode8(enc_d).cpu(), 10)
    extras["decode_p50_ms_h8"] = round(
        float(np.percentile(lat8, 50)) * 1e3, 2)


def sec_t192(run: Run) -> None:
    extras = run.result["extras"]
    T2 = 192
    cfg = dataclasses.replace(run.cfg, max_len=T2)
    enc192 = run.to_dev(run.tok_batch(run.ENC_BATCH, T2))
    sk192, _ = marginal_encode(run, run.model(cfg), enc192)
    extras["encode_T192_sketches_per_sec"] = round(sk192, 1)
    extras["mfu_encode_T192"] = round(
        sk192 * embed_flops_per_sketch(cfg, T2) / timing.PEAK_BF16, 3)


def sec_cont(run: Run) -> None:
    """The continuous (MDN, 20 mixtures) model on the flagship trunk:
    encode, greedy MDN decode, train."""
    from sketchformer_tpu_torch.infer import decode as dec

    extras = run.result["extras"]
    SEQ, TB = run.SEQ, run.TB
    cfgc = dataclasses.replace(run.cfg, use_continuous=True, num_mixtures=20,
                               max_len=SEQ)
    modelc = run.model(cfgc)
    rows = run.rng.standard_normal((run.ENC_BATCH, SEQ, 5)).astype(np.float32)
    rows[..., 2:] = 0.0
    rows[..., 2] = 1.0
    rows[:, -4:, 2:] = 0.0
    rows[:, -4:, 4] = 1.0
    # the JAX benchmark draws (x, y, 3 pen states) rows and its encoder's
    # input width follows them; the model's encoder reads stroke-3 rows
    # (x, y, pen lifted), as the data pipeline builds them: the first
    # three columns
    rows3 = np.ascontiguousarray(rows[..., :3])
    maskc = np.ones((run.ENC_BATCH, SEQ), np.float32)
    sk, _ = marginal_encode(run, modelc, run.to_dev(rows3), run.to_dev(maskc))
    extras["cont_encode_sketches_per_sec"] = round(sk, 1)
    run.emit()

    cdecode = dec.make_cont_decoder(modelc, max_len=SEQ)
    encd = run.to_dev(rows3[:run.DEC_BATCH])
    maskd = run.to_dev(maskc[:run.DEC_BATCH])
    out = run.launched(("decode_cont_chunk",), lambda: cdecode(encd, maskd))
    decode_check("cont decode", modelc, encd, maskd, out)
    latc = host_seconds(lambda: cdecode(encd, maskd)[0].cpu(), 10)
    extras["cont_decode_p50_ms"] = round(
        float(np.percentile(latc, 50)) * 1e3, 2)
    run.emit()

    pen_cls = np.argmax(rows[:TB, :, 2:], axis=-1).astype(np.int32)
    batchc = {
        "enc": rows3[:TB], "dec_in": rows[:TB],
        "tgt_xy": rows[:TB, :, :2].astype(np.float32),
        "tgt_pen": pen_cls,
        "enc_mask": maskc[:TB],
        "dec_mask": maskc[:TB],
        "label": run.rng.integers(0, 345, TB).astype(np.int32),
    }
    extras["cont_train_sketches_per_sec"] = timed_train(run, cfgc, batchc,
                                                        "cont train")


def sec_b1024(run: Run) -> None:
    extras = run.result["extras"]
    enc1k = run.tok_batch(1024, run.SEQ)
    dec1k = np.roll(enc1k, 1, axis=1)
    dec1k[:, 0] = 1
    batch1k = {
        "enc": enc1k, "dec_in": dec1k, "dec_tgt": enc1k,
        "label": run.rng.integers(0, 345, 1024).astype(np.int32),
    }
    extras["train_B1024_sketches_per_sec"] = timed_train(run, run.cfg,
                                                         batch1k, "b1024")


def sec_embed_pipeline(run: Run) -> None:
    """``tools/bench_embed_pipeline.measure``: the gallery's shard read,
    tokenize, pad, copy, encode and readback, end to end and host only."""
    from sketchformer_tpu_torch.tools import bench_embed_pipeline

    extras = run.result["extras"]
    extras.update(bench_embed_pipeline.measure(verbose=True, device=run.dev))


def sec_decode_realistic(run: Run) -> None:
    """``tools/bench_decode_realistic``: the flagship trained by its fixed
    recipe under a wall-clock cap, then its early-exit decode at K 8, 16
    and 32."""
    from sketchformer_tpu_torch.tools import bench_decode_realistic as bdr

    extras = run.result["extras"]
    cap = max(60.0, min(300.0, run.remaining() - 150.0))
    model, val = bdr.get_trained_flagship(max_seconds=cap, device=run.dev)
    if model is None:
        extras["skipped"].append(f"decode_realistic (training did not "
                                 f"finish within the {cap:.0f} s cap)")
        return
    extras.update(bdr.measure(model, val))


def sections() -> List[Tuple[str, float, Callable[[Run], None]]]:
    """(name, estimate in seconds, fn) of each section, in the JAX
    benchmark's order: the headline, which always runs, then the
    budget-gated ones. An estimate is twice the section's seconds in a
    run on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6), the
    checks and the gallery's generation (20k and 100k synthetic sketches)
    included."""
    return [
        ("headline", 7.0, sec_headline),
        ("train", 30.2, sec_train),
        ("decode", 10.2, sec_decode),
        ("h8_train", 10.2, sec_h8_train),
        ("h8_encode", 13.2, sec_h8_encode),
        ("h8_decode", 3.6, sec_h8_decode),
        ("t192_encode", 7.2, sec_t192),
        ("cont", 14.8, sec_cont),
        ("b1024_train", 6.2, sec_b1024),
        ("embed_pipeline", 41.6, sec_embed_pipeline),
        ("decode_realistic", 458.4, sec_decode_realistic),
    ]


def prefix_budget(n: int) -> float:
    """A budget under which exactly the first ``n`` sections run: their
    estimates and half the next one's."""
    est = [e for _, e, _ in sections()]
    return sum(est[:n]) + est[n] / 2


def setup_card(dev: torch.device) -> Dict[str, object]:
    """Build and load the kernels, start the card; the result line's
    device keys and ``build_s``."""
    from sketchformer_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise RuntimeError("bench: --device cuda but torch.cuda.is_available()"
                           " is False")
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    return {"gpu": timing.gpu_line(),
            "nvcc": timing.nvcc_version(_build._nvcc()),
            "device": torch.cuda.get_device_name(dev),
            "build_s": round(time.perf_counter() - t0, 1)}


def config_tag(c: SketchformerConfig) -> str:
    dt = {"bfloat16": "bf16", "float32": "f32"}[c.dtype]
    return (f"d{c.d_model}-L{c.num_layers}-H{c.num_heads}x"
            f"{c.d_model // c.num_heads}-dff{c.dff}-{dt}-{c.attn_impl}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sketchformer_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:0 or cpu")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    card = setup_card(dev) if dev.type == "cuda" else {}
    run = Run(dev, float(os.environ.get(BUDGET_ENV, DEFAULT_BUDGET_S)),
              sys.stdout)
    extras = {
        "seq_len": run.SEQ,
        "batch": run.ENC_BATCH,
        "num_heads": run.cfg.num_heads,
        "config": config_tag(run.cfg),
        "config_h8": config_tag(run.cfg8) + " (reference geometry)",
        "budget_s": run.budget_s,
        "skipped": [],
        "gpu": card.get("gpu"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda if run.on_card else None,
        "nvcc": card.get("nvcc"),
        "device": card.get("device", str(dev)),
        "build_s": card.get("build_s"),
        "section_s": {},
    }
    result = {
        "metric": "encode_sketches_per_sec_per_chip",
        "value": 0.0,
        "unit": "sketches/sec/chip",
        "extras": extras,
    }
    run.result = result
    table = sections()
    if not run.on_card:
        table = table[:3]
    failed = out_of_budget = False
    planned = 0.0   # the estimates of the sections run so far
    for name, est, fn in table:
        if name != "headline" and (out_of_budget
                                   or planned + est > run.budget_s):
            out_of_budget = True
            note(run, f"skip {name}: {run.budget_s - planned:.1f}s of the "
                      f"budget left, {est}s estimate")
            extras["skipped"].append(name)
            continue
        planned += est
        left = run.budget_s - planned
        note(run, f"section {name} (est {est}s, {left:.1f}s left after it)")
        t0 = time.monotonic()
        try:
            # the checks' lines and the tools' notes go to stderr
            with contextlib.redirect_stdout(sys.stderr):
                fn(run)
        except Exception as e:  # noqa: BLE001 -- record, keep the line whole
            traceback.print_exc(file=sys.stderr)
            note(run, f"section {name} FAILED: {type(e).__name__}: {e}")
            extras[f"{name}_error"] = f"{type(e).__name__}: {e}"
            failed = True
        extras["section_s"][name] = round(time.monotonic() - t0, 1)
        if run.on_card:
            torch.cuda.empty_cache()
        run.emit()
    note(run, f"done in {run.elapsed():.1f}s (budget {run.budget_s:.0f}s)")
    run.emit()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
