"""End-to-end gallery embedding throughput on the card: the port of
``tools/bench_embed_pipeline.py``.

The benchmark's headline encode is the marginal cost of the kernels; what
SBIR and eval users run is ``infer/encode.py::embed_dataset``: shard read,
tokenize (the C batcher), bucket and pad, a pinned host-to-device copy,
the kernel encode, the z readback and the ``is_real`` filter. This tool
times that whole path over a gallery on disk, and the host pipeline alone,
so that the gap splits into host and device plus overlap.

    python -m sketchformer_tpu_torch.tools.bench_embed_pipeline [--json]

The gallery (100,000 synthetic sketches of 64 classes, the JAX tool's
seeds and splits) is written once under the temporary directory
(``sketchformer_tpu_torch_gallery_{n}``), keyed by its size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

GALLERY_N = 100_000
BATCH = 2048
BUCKET = 96  # matches the headline encode row (T=96, B=2048)


def prepare_gallery(n: int = GALLERY_N, out: str | None = None) -> str:
    """Write (once) ``n`` synthetic sketches of 64 classes as shards:
    seed 11, shard seed 5, splits (0.98, 0.01, 0.01), 8,192 a shard, as the
    JAX tool does. ``out`` defaults to the cache under the temporary
    directory; returns the directory."""
    if out is None:
        out = os.path.join(tempfile.gettempdir(),
                           f"sketchformer_tpu_torch_gallery_{n}")
    if os.path.exists(os.path.join(out, "meta.npz")):
        return out
    from sketchformer_tpu_torch.data import synthetic
    from sketchformer_tpu_torch.data.shards import write_shards

    num_classes = 64
    sketches, labels = synthetic.generate_dataset(
        num_classes, n // num_classes, seed=11)
    write_shards(out, sketches, np.asarray(labels),
                 [f"c{i}" for i in range(num_classes)],
                 splits=(0.98, 0.01, 0.01), shard_size=8192, seed=5)
    return out


def measure(verbose: bool = True, device="cuda") -> dict:
    """Returns {'embed_pipeline_sketches_per_sec',
    'embed_host_sketches_per_sec', 'embed_gallery_n'}: the end-to-end and
    host-only rates over the gallery's train split (the flagship model,
    seeded random weights, bf16 on the kernels). The first valid batch's z
    is held to the plain encoder stack before the timed pass."""
    import torch

    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.convert import init_params
    from sketchformer_tpu_torch.data.registry import DistributedStroke3Loader
    from sketchformer_tpu_torch.infer.encode import embed_dataset
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.utils.checks import (
        ENCODE_KERNELS,
        embed_check,
        launched,
    )

    dev = torch.device(device)
    data_dir = prepare_gallery()
    loader = DistributedStroke3Loader(
        data_dir, batch_size=BATCH, buckets=(BUCKET,), grid_resolution=100,
        seed=0, process_index=0, process_count=1)
    on_card = dev.type == "cuda"
    cfg = SketchformerConfig(
        vocab_size=loader.vocab_size, num_classes=loader.num_classes,
        max_len=BUCKET, d_model=256, num_layers=8, num_heads=2, dff=512,
        dropout=0.1, lowerdim=256, dtype="bfloat16",
        attn_impl="pallas" if on_card else "xla")
    model = Sketchformer(cfg)
    model.load_state_dict(init_params(cfg, 0))
    model = model.to(dev).eval()

    # --- phase A: host pipeline alone (no device) ------------------------
    t0 = time.perf_counter()
    n_host = 0
    for b in loader.batch_iterator("train"):
        n_host += b["enc"].shape[0]
    host_dt = time.perf_counter() - t0
    if verbose:
        print(f"host pipeline: {n_host:,} sketches in {host_dt:.2f}s "
              f"({n_host / host_dt:,.0f} sk/s)", flush=True)

    # --- phase B: end-to-end embed_dataset (checked and warm first) ------
    warm = list(loader.batch_iterator("valid"))[:1]
    launched(ENCODE_KERNELS, lambda: embed_check(
        f"embed_pipeline valid batch of {warm[0]['enc'].shape[0]}", model,
        torch.from_numpy(warm[0]["enc"]).to(dev)), on_card)
    embed_dataset(model, warm)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    Z, labels = embed_dataset(model, loader.batch_iterator("train"))
    dt = time.perf_counter() - t0
    if verbose:
        print(f"embed_dataset: {len(Z):,} embeddings in {dt:.2f}s "
              f"({len(Z) / dt:,.0f} sk/s end-to-end)  Z={Z.shape}",
              flush=True)
        print(f"device+overlap residual: {dt - host_dt:.2f}s "
              f"(host fraction {host_dt / dt:.0%})", flush=True)
    return {
        "embed_pipeline_sketches_per_sec": round(len(Z) / dt, 1),
        "embed_host_sketches_per_sec": round(n_host / host_dt, 1),
        "embed_gallery_n": int(len(Z)),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="sketchformer_tpu_torch.tools.bench_embed_pipeline")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line of the rates only")
    args = p.parse_args(argv)
    if args.json:
        # the check's line goes to stderr, the one result line to stdout
        with contextlib.redirect_stdout(sys.stderr):
            got = measure(verbose=False)
        print(json.dumps(got), flush=True)
    else:
        measure()


if __name__ == "__main__":
    sys.exit(main())
