"""Basic usage of the PyTorch port, as ``examples/basic_usage.py`` shows the
JAX package's: train a model briefly, restore it from its run dir, embed
sketches, classify and retrieve them, reconstruct them by autoregressive
decode, and interpolate between two embeddings.

Run (it trains a small model first, since no pretrained checkpoint ships
with the repo; point ``--run-dir`` at a trained run to resume it)::

    python -m sketchformer_tpu_torch.examples.basic_usage \\
        [--run-dir out/basic_usage_torch] [--steps 200] [--device cuda]

On the card the model runs in bfloat16 on the hand-written kernels
(``attn_impl='pallas'``); ``--device cpu`` runs float32 on their plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from sketchformer_tpu_torch.convert import init_params
from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
from sketchformer_tpu_torch.infer import decode as dec
from sketchformer_tpu_torch.infer.encode import embed_dataset, interpolate
from sketchformer_tpu_torch.infer.sbir import (
    classification_eval,
    retrieval_eval,
)
from sketchformer_tpu_torch.models import Sketchformer, SketchformerConfig
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
from sketchformer_tpu_torch.train.loop import TrainLoopConfig, run_training
from sketchformer_tpu_torch.utils.metrics import reconstruction_grid


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default="out/basic_usage_torch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda or cpu")
    ap.add_argument("--d-model", type=int, default=128,
                    help="model width (dff 2x, embedding 1/2x)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=64)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. data + model ------------------------------------------------------
    loader = get_dataloader_by_name("synthetic")(
        num_classes=8, sketches_per_epoch=32 * args.batch_size,
        batch_size=args.batch_size, buckets=(args.max_len,))
    on_card = dev.type == "cuda"
    cfg = SketchformerConfig(
        vocab_size=loader.vocab_size, num_classes=8, max_len=args.max_len,
        d_model=args.d_model, num_layers=2, dff=2 * args.d_model,
        lowerdim=args.d_model // 2, dropout=0.1,
        dtype="bfloat16" if on_card else "float32",
        attn_impl="pallas" if on_card else "xla")
    model = Sketchformer(cfg)
    model.load_state_dict(init_params(cfg, seed=0))
    model.to(dev)

    # 2. train briefly (or resume a previous run) --------------------------
    final = run_training(
        model, loader, args.run_dir,
        TrainLoopConfig(total_steps=args.steps, eval_every=args.steps,
                        save_every=args.steps, warmup_steps=50,
                        peak_scale=4.0))
    print("eval:", {k: round(v, 3) for k, v in final.items()})

    # restore the model from the run dir we just wrote (its config.json and
    # newest checkpoint), as a server would
    ckpt = CheckpointManager(args.run_dir)
    model = Sketchformer(SketchformerConfig(**ckpt.load_config_dict()))
    model.load_state_dict(ckpt.load_state_dict()["params"])
    model.to(dev).eval()

    # 3. embed, classify and retrieve --------------------------------------
    batches = loader.get_validation_set(max_batches=4)
    Z, labels = embed_dataset(model, batches)
    print("embeddings:", Z.shape)
    with torch.no_grad():
        logits = model.classify(torch.from_numpy(Z).to(dev)).cpu().numpy()
    cls = classification_eval(logits, labels)
    print("classification:", {k: round(v, 3) for k, v in cls.items()})
    ret = retrieval_eval(Z, labels, Z, labels, exclude_self=True)
    print("retrieval:", {k: round(v, 3) for k, v in ret.items()})

    # 4. reconstruct by KV-cached AR decode ---------------------------------
    first = batches[0]
    enc = torch.from_numpy(first["enc"]).to(dev)
    ids = dec.make_token_decoder(model)(enc)
    recon = dec.tokens_to_sketches(loader.tokenizer, ids.cpu())
    originals = [loader.tokenizer.decode(row) for row in first["enc"]]
    grid = reconstruction_grid(originals, recon)
    out = os.path.join(args.run_dir, "reconstruction_grid.npy")
    np.save(out, grid)
    nonempty = sum(len(s) > 0 for s in recon)
    print(f"reconstructions: {nonempty}/{len(recon)} non-empty; grid saved "
          f"to {out}")

    # 5. interpolate between two embeddings ---------------------------------
    path = interpolate(Z[0], Z[1], steps=5).astype(np.float32)
    ids_i = dec.make_token_decoder_from_z(model)(torch.from_numpy(path).to(dev))
    interp = dec.tokens_to_sketches(loader.tokenizer, ids_i.cpu())
    print("interpolation lengths:", [len(s) for s in interp])
    summary = {"embeddings": list(Z.shape), "top1": cls["top1"],
               "reconstructions": len(recon), "nonempty": nonempty,
               "interpolation": len(interp), "grid": list(grid.shape),
               **final}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
