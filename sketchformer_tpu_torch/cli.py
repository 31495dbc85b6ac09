"""Command line for the PyTorch port: embedding extraction and SBIR eval.

Port of the ``embed`` and ``sbir`` subcommands of ``sketchformer_tpu.cli``.
The loader and preset come from the JAX package's own (JAX-free) data
path; weights come from an ``.npz`` written by ``convert.save_npz`` or from
a seeded initialisation::

    python -m sketchformer_tpu_torch.cli embed --preset sbir --init-seed 0 \\
        --device cuda --output z.npz
    python -m sketchformer_tpu_torch.cli sbir --preset sbir \\
        --weights weights.npz --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

import numpy as np
import torch

from sketchformer_tpu.cli import _resolve_loader_config
from sketchformer_tpu_torch.config import SketchformerConfig


def build_model_and_loader(args):
    """(model on ``args.device`` in eval mode, loader) from preset/flags."""
    from sketchformer_tpu.data.registry import get_dataloader_by_name
    from sketchformer_tpu.presets import get_preset
    from sketchformer_tpu_torch.convert import init_params, load_npz
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    model_over: Dict[str, Any] = {}
    if args.preset:
        model_over.update(get_preset(args.preset).model_overrides)
    loader_name, loader_kwargs = _resolve_loader_config(args)
    loader = get_dataloader_by_name(loader_name)(**loader_kwargs)

    hps = SketchformerConfig.default_hparams()
    for k, v in model_over.items():
        setattr(hps, k, v)
    if args.hparams:
        hps.parse(args.hparams)
    explicit = {item.split("=", 1)[0].strip()
                for item in (args.hparams or "").split(",") if "=" in item}
    # dataset-derived fields unless explicitly overridden (as the JAX CLI)
    if "vocab_size" not in explicit:
        hps.vocab_size = loader.vocab_size
    if "num_classes" not in explicit:
        hps.num_classes = (max(loader.num_classes, hps.num_classes)
                           if args.preset else loader.num_classes)
    cfg = SketchformerConfig.from_hparams(hps)

    if args.weights:
        state = load_npz(args.weights)
    else:
        state = init_params(cfg, args.init_seed)
    model = Sketchformer(cfg)
    model.load_state_dict(state)
    return model.to(torch.device(args.device)).eval(), loader


def cmd_embed(args) -> int:
    from sketchformer_tpu_torch.infer.encode import embed_dataset

    model, loader = build_model_and_loader(args)
    batches = loader.get_validation_set(max_batches=args.max_batches)
    Z, labels = embed_dataset(model, batches)
    np.savez(args.output, embeddings=Z, labels=labels)
    print(json.dumps({"embeddings": list(Z.shape), "output": args.output}))
    return 0


def cmd_sbir(args) -> int:
    """Gallery retrieval eval: embed a gallery + queries, kNN metrics.

    Default protocol: disjoint query/gallery halves; ``--self-retrieval``
    evaluates Z against itself with the diagonal excluded.
    """
    from sketchformer_tpu.infer.sbir import retrieval_eval
    from sketchformer_tpu_torch.infer.encode import embed_dataset

    model, loader = build_model_and_loader(args)
    batches = loader.get_validation_set(max_batches=args.max_batches)
    Z, labels = embed_dataset(model, batches)
    if args.self_retrieval or len(Z) < 4:
        metrics = retrieval_eval(Z, labels, Z, labels, exclude_self=True)
        metrics["protocol"] = "self"
    else:
        half = len(Z) // 2
        metrics = retrieval_eval(
            Z[:half], labels[:half], Z[half:], labels[half:])
        metrics["protocol"] = "disjoint"
    metrics["gallery_size"] = (len(Z) if args.self_retrieval
                               else len(Z) - len(Z) // 2)
    if args.output:
        np.savez(args.output, embeddings=Z, labels=labels)
    print(json.dumps({
        k: (round(float(v), 4) if not isinstance(v, str) else v)
        for k, v in metrics.items()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sketchformer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", default=None)
        sp.add_argument("--loader", default=None)
        sp.add_argument("--data-dir", default=None)
        sp.add_argument("--hparams", default=None,
                        help="model overrides: k=v,k=v")
        sp.add_argument("--loader-arg", action="append", default=[],
                        help="loader kwarg k=v (repeatable)")
        sp.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda, cuda:0 or cpu")
        src = sp.add_mutually_exclusive_group(required=True)
        src.add_argument("--weights", default=None,
                         help="npz from sketchformer_tpu_torch.convert")
        src.add_argument("--init-seed", type=int, default=None,
                         help="seeded random initialisation")

    sp = sub.add_parser("embed", help="extract bottleneck embeddings")
    common(sp)
    sp.add_argument("--max-batches", type=int, default=8)
    sp.add_argument("--output", default="embeddings.npz")
    sp.set_defaults(fn=cmd_embed)

    sp = sub.add_parser("sbir", help="gallery retrieval eval (top-k, mAP)")
    common(sp)
    sp.add_argument("--max-batches", type=int, default=16)
    sp.add_argument("--self-retrieval", action="store_true",
                    help="eval Z vs itself (diag excluded) instead of "
                         "disjoint query/gallery halves")
    sp.add_argument("--output", default=None,
                    help="optionally dump embeddings npz")
    sp.set_defaults(fn=cmd_sbir)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
