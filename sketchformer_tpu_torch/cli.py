"""Command line for the PyTorch port: training and eval (token and
continuous (MDN) models), embedding extraction, SBIR eval, AR
reconstruction and latent interpolation.

Port of the ``train``, ``eval``, ``embed``, ``sbir``, ``decode`` and
``interpolate`` subcommands of ``sketchformer_tpu.cli``, with the same
outputs. Loaders and presets are the port's copies (``data/``,
``presets.py``). ``train`` writes a run dir (config, loader config,
checkpoints, metrics) that ``eval`` reads; the serving subcommands take
weights from an ``.npz`` written by ``convert.save_npz`` or a seeded
initialisation::

    python -m sketchformer_tpu_torch.cli train --preset cont2cont_mdn \
        --run-dir R --device cuda --loop-arg total_steps=30
    python -m sketchformer_tpu_torch.cli train --preset pretrain_full \
        --loader synthetic --loader-arg num_classes=345 --run-dir R2 \
        --device cuda --loop-arg total_steps=30 --loop-arg warmup_steps=500
    python -m sketchformer_tpu_torch.cli eval --run-dir R --device cuda

    python -m sketchformer_tpu_torch.cli embed --preset sbir --init-seed 0 \\
        --device cuda --output z.npz
    python -m sketchformer_tpu_torch.cli sbir --preset sbir \\
        --weights weights.npz --device cuda
    python -m sketchformer_tpu_torch.cli decode --preset ar_decode \\
        --init-seed 0 --device cuda
    python -m sketchformer_tpu_torch.cli interpolate --preset ar_decode \\
        --init-seed 0 --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

import numpy as np
import torch

from sketchformer_tpu_torch.config import SketchformerConfig


def _parse_kv(items) -> Dict[str, Any]:
    """``k=v`` flags -> dict; values parse as JSON, else as Python-style
    literals (``False`` must not become the truthy string "False"), else
    stay strings."""
    out: Dict[str, Any] = {}
    for item in items or []:
        k, v = item.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            lit = {"true": True, "false": False, "none": None}
            out[k] = lit[v.lower()] if v.lower() in lit else v
    return out


def _resolve_loader_config(args):
    """(loader_name, loader_kwargs) from preset and/or explicit flags."""
    from sketchformer_tpu_torch.presets import get_preset

    loader_name = args.loader
    loader_kwargs: Dict[str, Any] = {}
    if args.preset:
        p = get_preset(args.preset)
        loader_name = loader_name or p.loader
        loader_kwargs.update(p.loader_kwargs)
    loader_name = loader_name or "synthetic"
    loader_kwargs.update(_parse_kv(getattr(args, "loader_arg", None)))
    if getattr(args, "data_dir", None):
        loader_kwargs["data_dir"] = args.data_dir
    return loader_name, loader_kwargs


def resolve_config(args):
    """(SketchformerConfig, loader) from preset and flags, the dataset's
    vocab and class count filled in unless ``--hparams`` sets them."""
    from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
    from sketchformer_tpu_torch.presets import get_preset

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
    return SketchformerConfig.from_hparams(hps), loader


def build_model_and_loader(args):
    """(model on ``args.device`` in eval mode, loader) from preset/flags."""
    from sketchformer_tpu_torch.convert import init_params, load_npz
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    cfg, loader = resolve_config(args)
    if args.weights:
        state = load_npz(args.weights)
    else:
        state = init_params(cfg, args.init_seed)
    model = Sketchformer(cfg)
    model.load_state_dict(state)
    return model.to(torch.device(args.device)).eval(), loader


def cmd_train(args) -> int:
    """Train from a seeded initialisation (``--loop-arg seed``) or resume
    the run dir's newest checkpoint; prints the final eval metrics."""
    from sketchformer_tpu_torch.convert import init_params
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.presets import get_preset
    from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
    from sketchformer_tpu_torch.train.loop import (
        TrainLoopConfig,
        run_training,
    )
    from sketchformer_tpu_torch.utils.notify import build_notifier

    cfg, loader = resolve_config(args)
    loop_over: Dict[str, Any] = {}
    if args.preset:
        loop_over.update(get_preset(args.preset).loop_overrides)
    loop_over.update(_parse_kv(args.loop_arg))
    loop_cfg = TrainLoopConfig(**loop_over)
    model = Sketchformer(cfg)
    model.load_state_dict(init_params(cfg, loop_cfg.seed))
    model.to(torch.device(args.device))
    # persist the data config so eval rebuilds the same loader
    loader_name, loader_kwargs = _resolve_loader_config(args)
    CheckpointManager(args.run_dir).save_meta(
        {"loader": loader_name, "loader_kwargs": loader_kwargs})
    final = run_training(model, loader, args.run_dir, loop_cfg,
                         notifier=build_notifier(args.notifier, args.run_dir))
    print(json.dumps({k: round(v, 4) for k, v in final.items()}))
    return 0


def restore_for_eval(args):
    """(model with the run dir's newest checkpoint on ``args.device``, in
    eval mode, and the run's loader)."""
    from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(args.run_dir)
    saved = ckpt.load_config_dict()
    if saved is None:
        raise FileNotFoundError(f"no config.json in {args.run_dir}")
    model = Sketchformer(SketchformerConfig(**saved))
    model.load_state_dict(ckpt.load_state_dict()["params"])
    meta = ckpt.load_meta()
    explicit = bool(args.loader or args.preset or args.loader_arg
                    or args.data_dir)
    if not explicit and "loader" in meta:
        loader = get_dataloader_by_name(meta["loader"])(
            **meta["loader_kwargs"])
    else:
        _, loader = resolve_config(args)
    return model.to(torch.device(args.device)).eval(), loader


def cmd_eval(args) -> int:
    """Mean eval metrics of the newest checkpoint over a split."""
    from sketchformer_tpu_torch.train.loop import evaluate
    from sketchformer_tpu_torch.train.step import make_eval_step

    model, loader = restore_for_eval(args)
    if args.split == "valid":
        batches = loader.get_validation_set(max_batches=args.max_batches)
    else:
        batches = []
        for b in loader.batch_iterator(args.split):
            batches.append(b)
            if len(batches) >= args.max_batches:
                break
    if not batches:
        print(f"no batches in split {args.split!r}", file=sys.stderr)
        return 1
    out = evaluate(make_eval_step(model), batches)
    print(json.dumps({k: round(v, 4) for k, v in out.items()}))
    return 0


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
    from sketchformer_tpu_torch.infer.sbir import retrieval_eval
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


def _save_sketches(path, sketches, **extra) -> int:
    """Write stroke-3 sketches as concatenated points + offsets (the JAX
    CLI's layout); returns how many are non-empty."""
    offsets = np.zeros(len(sketches) + 1, np.int64)
    offsets[1:] = np.cumsum([len(s) for s in sketches])
    points = (np.concatenate(sketches, axis=0)
              if any(len(s) for s in sketches) else np.zeros((0, 3)))
    np.savez(path, points=points, offsets=offsets, **extra)
    return int(sum(len(s) > 0 for s in sketches))


def first_batch(model, loader):
    """The first validation batch: (batch dict, enc, enc_mask or None) on
    the model's device."""
    dev = next(model.parameters()).device
    batch = loader.get_validation_set(max_batches=1)[0]
    enc = torch.from_numpy(batch["enc"]).to(dev)
    mask = (torch.from_numpy(batch["enc_mask"]).to(dev)
            if model.config.use_continuous else None)
    return batch, enc, mask


def _sample_generator(model):
    """Fixed-seed generator for MDN temperature sampling (the JAX CLI
    samples from PRNGKey(0))."""
    dev = next(model.parameters()).device
    return torch.Generator(device=dev).manual_seed(0)


def cmd_decode(args) -> int:
    """AR reconstruction of the first validation batch."""
    from sketchformer_tpu_torch.infer import decode as dec

    model, loader = build_model_and_loader(args)
    batch, enc, mask = first_batch(model, loader)
    if model.config.use_continuous:
        decode = dec.make_cont_decoder(model, temperature=args.temperature)
        xy, pen, valid = decode(enc, mask, _sample_generator(model))
        sketches = dec.cont_to_sketches(
            xy.cpu().numpy(), pen.cpu().numpy(), valid.cpu().numpy(),
            scale=loader.scale)
    else:
        ids = dec.make_token_decoder(model)(enc)
        sketches = dec.tokens_to_sketches(loader.tokenizer, ids.cpu())
    nonempty = _save_sketches(args.output, sketches, labels=batch["label"])
    print(json.dumps({"sketches": len(sketches), "nonempty": nonempty,
                      "output": args.output}))
    return 0


def cmd_interpolate(args) -> int:
    """Latent interpolation between two validation sketches, decoded from
    z and rendered as a raster strip."""
    from sketchformer_tpu_torch.utils.metrics import sketch_strip
    from sketchformer_tpu_torch.infer import decode as dec
    from sketchformer_tpu_torch.infer.encode import interpolate, make_embed_fn

    model, loader = build_model_and_loader(args)
    batch, enc, mask = first_batch(model, loader)
    Z = make_embed_fn(model)(enc, mask).cpu().numpy()
    i, j = args.index_a, args.index_b
    if j is None:  # default: first sketch with a different label
        labels = np.asarray(batch["label"])
        distinct = np.flatnonzero(labels != labels[i])
        j = int(distinct[0]) if len(distinct) else (i + 1) % len(Z)
    path = interpolate(Z[i], Z[j], steps=args.steps).astype(Z.dtype)
    z = torch.from_numpy(path).to(enc.device)
    if model.config.use_continuous:
        decode = dec.make_cont_decoder_from_z(
            model, temperature=args.temperature)
        xy, pen, valid = decode(z, _sample_generator(model))
        sketches = dec.cont_to_sketches(
            xy.cpu().numpy(), pen.cpu().numpy(), valid.cpu().numpy(),
            scale=loader.scale)
    else:
        ids = dec.make_token_decoder_from_z(model)(z)
        sketches = dec.tokens_to_sketches(loader.tokenizer, ids.cpu())
    nonempty = _save_sketches(args.output, sketches, embeddings=path,
                              strip=sketch_strip(sketches))
    print(json.dumps({"steps": args.steps, "index_a": i, "index_b": j,
                      "nonempty": nonempty, "output": args.output}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sketchformer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def data_args(sp):
        sp.add_argument("--preset", default=None)
        sp.add_argument("--loader", default=None)
        sp.add_argument("--data-dir", default=None)
        sp.add_argument("--hparams", default=None,
                        help="model overrides: k=v,k=v")
        sp.add_argument("--loader-arg", action="append", default=[],
                        help="loader kwarg k=v (repeatable)")
        sp.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda, cuda:0 or cpu")

    sp = sub.add_parser("train", help="train a token or continuous model")
    data_args(sp)
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--loop-arg", action="append", default=[],
                    help="loop config k=v (repeatable)")
    sp.add_argument("--notifier", default="file",
                    help="none | file | webhook:<url>")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="evaluate the newest checkpoint")
    data_args(sp)
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--max-batches", type=int, default=8)
    sp.add_argument("--split", default="valid",
                    choices=["train", "valid", "test"])
    sp.set_defaults(fn=cmd_eval)

    def common(sp):
        data_args(sp)
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

    sp = sub.add_parser("interpolate",
                        help="latent interpolation between two val sketches")
    common(sp)
    sp.add_argument("--steps", type=int, default=8)
    sp.add_argument("--index-a", type=int, default=0)
    sp.add_argument("--index-b", type=int, default=None,
                    help="default: first val sketch with a different label")
    sp.add_argument("--temperature", type=float, default=0.0)
    sp.add_argument("--output", default="interpolation.npz")
    sp.set_defaults(fn=cmd_interpolate)

    sp = sub.add_parser("decode", help="AR reconstruction of a val batch")
    common(sp)
    sp.add_argument("--temperature", type=float, default=0.0)
    sp.add_argument("--output", default="reconstructions.npz")
    sp.set_defaults(fn=cmd_decode)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
