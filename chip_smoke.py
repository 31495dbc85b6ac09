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
4. main path: the port's ``sbir`` CLI at the full width of the ``sbir``
   preset (seeded random weights) over 16 batches of 64 from the preset's
   synthetic 345-class loader, with the kernel launch counters reset
   just before and read just after; then classifier logits on z, and the
   kernel z against the plain-path z on one batch;
5. times: kernel vs plain (CUDA events after warm-up) and the end-to-end
   embed rate, each with the card's name and power limit.

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
SOURCE = "sketchformer_tpu_torch/csrc/encoder_stack.cu"
# TPU kernel each Hopper kernel replaces (the body of fused_encoder_stack;
# at H=8 its attention and qk-norm run in pallas_packed.group_attn_fwd)
REPLACES = {
    "linear": "sketchformer_tpu/ops/pallas_encoder.py:140",
    "encoder_attention": "sketchformer_tpu/ops/pallas_packed.py:169",
    "layernorm_rows": "sketchformer_tpu/ops/pallas_encoder.py:63",
}
# max |kernel - plain| / max |plain| allowed, by dtype
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the whole bf16 stack: max |kernel - f32| <= this x max |plain bf16 - f32|
STACK_BF16_FACTOR = 2.0
SBIR = dict(T=192, d=256, H=8, dff=512, L=8)
SKETCHES_PER_EPOCH = 345 * 32   # 1380 validation sketches -> >= 16 batches
MAIN_BATCHES = 16


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


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sketchformer_tpu_torch import cli
    from sketchformer_tpu_torch.infer.encode import embed_dataset
    from sketchformer_tpu_torch.infer.fast_encode import fast_embed
    from sketchformer_tpu_torch.ops import _build
    from sketchformer_tpu_torch.ops import encoder_stack as es

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
        es.reset_launches()
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

    # ---- 5. times ----------------------------------------------------------
    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def paired(kernel_fn, plain_fn, iters=20):
        """plain, kernel, kernel, plain on one card; means of each pair."""
        p1 = cuda_ms(plain_fn, iters)
        k1 = cuda_ms(kernel_fn, iters)
        k2 = cuda_ms(kernel_fn, iters)
        p2 = cuda_ms(plain_fn, iters)
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

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "jaxlib"))
    if leaked:
        fail(f"JAX was imported: {leaked[:5]}")

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
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
