"""Reference-checkpoint import for the PyTorch port: the port's counterpart
of ``tools/import_reference_weights.py``, with the same flags, template and
checks, and a TF2 checkpoint read without TensorFlow (``tf_bundle``).

1. ``--dump-template map.json``: every parameter of the model the config
   builds (``SketchformerConfig.default_hparams()`` plus ``--hparams``), as
   ``path -> {shape, dtype, ref, transpose}``. A path is the flax path
   joined with ``/`` (the ``state_dict`` key with ``/`` for ``.``), so the
   template is the JAX tool's letter for letter and one mapping serves
   both. With ``--tf-ckpt`` the ``ref`` fields are proposed by shape: a
   shape unique on both sides is a firm match, same-shape groups are
   zipped in name order and flagged ``auto_ambiguous``, and a 2-D shape
   that matches only transposed gets ``transpose: [1, 0]``.
2. Fill in or fix the ``ref`` fields (the checkpoint's variable names)
   and ``transpose`` axes.
3. ``--weights ref.npz | --tf-ckpt DIR_OR_PREFIX`` with ``--mapping
   map.json --out RUN_DIR``: every parameter is read, transposed, held to
   its shape and cast to its dtype; any unmapped or mismatched parameter is
   listed on stderr and the tool exits 1. Otherwise it writes a run dir
   (``config.json`` and checkpoint step 0: the imported parameters, a
   fresh Noam Adam and seed 0) that ``cli.py eval / embed / sbir / decode /
   interpolate --run-dir`` serve and ``train --run-dir`` resumes.

The tool moves arrays on the host; it needs neither TensorFlow nor
``protobuf``::

    python -m sketchformer_tpu_torch.tools.import_reference_weights \\
        --tf-ckpt ref_ckpt_dir --dump-template map.json \\
        --hparams d_model=256,num_layers=8
    python -m sketchformer_tpu_torch.tools.import_reference_weights \\
        --tf-ckpt ref_ckpt_dir --mapping map.json --out out/reference_import
    python -m sketchformer_tpu_torch.tools.import_reference_weights \\
        --weights w.npz --mapping map.json --out out/reference_import
    python -m sketchformer_tpu_torch.cli embed --run-dir out/reference_import \\
        --preset sbir --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.convert import init_params
from sketchformer_tpu_torch.tools.tf_bundle import TFCheckpointSource


def build_config(hparams: Optional[str]) -> SketchformerConfig:
    hps = SketchformerConfig.default_hparams()
    if hparams:
        hps.parse(hparams)
    return SketchformerConfig.from_hparams(hps)


def template_leaves(cfg: SketchformerConfig) -> Dict[str, np.ndarray]:
    """The model's parameters keyed by their flax path joined with ``/``."""
    return {k.replace(".", "/"): v.numpy()
            for k, v in init_params(cfg, 0).items()}


def dump_template(leaves: Dict[str, np.ndarray]) -> dict:
    return {path: {"shape": list(leaf.shape), "dtype": str(leaf.dtype),
                   "ref": "", "transpose": None}
            for path, leaf in sorted(leaves.items())}


def propose_mapping(template: dict, src) -> dict:
    """Fill the ``ref`` fields by shape matching against ``src.shapes``:
    a shape unique on both sides is firm; same-shape groups are zipped in
    name order and flagged ``auto_ambiguous``; a 2-D shape found only
    transposed gets ``transpose: [1, 0]``."""
    ours_by_shape: dict = {}
    for path, spec in template.items():
        ours_by_shape.setdefault(tuple(spec["shape"]), []).append(path)
    refs_by_shape: dict = {}
    for name, shape in src.shapes.items():
        refs_by_shape.setdefault(tuple(shape), []).append(name)

    for shape, paths in ours_by_shape.items():
        names = sorted(refs_by_shape.get(shape, []))
        transpose = None
        if not names and len(shape) == 2 and shape[0] != shape[1]:
            names = sorted(refs_by_shape.get(shape[::-1], []))
            transpose = [1, 0]
        if not names:
            continue
        ambiguous = len(paths) > 1 or len(names) > 1
        for path, name in zip(sorted(paths), names):
            template[path]["ref"] = name
            template[path]["transpose"] = transpose
            if ambiguous:
                template[path]["auto_ambiguous"] = True
    return template


def save_run_dir(out: str, cfg: SketchformerConfig,
                 state_dict: Dict[str, torch.Tensor]) -> None:
    """``config.json`` and checkpoint step 0: ``state_dict``, a fresh
    optimizer (count 0, zero moments) and dropout seed 0."""
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
    from sketchformer_tpu_torch.train.schedule import make_optimizer
    from sketchformer_tpu_torch.train.step import TrainState

    model = Sketchformer(cfg)
    model.load_state_dict(state_dict)
    opt = make_optimizer(list(model.parameters()), cfg.d_model)
    mgr = CheckpointManager(out)
    mgr.save_config(cfg)
    mgr.save(TrainState(model, opt, 0, 0), force=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Import reference weights (npz or TF2 checkpoint) into "
                    "a run dir of the PyTorch port.")
    ap.add_argument("--hparams", default=None)
    ap.add_argument("--dump-template", default=None)
    ap.add_argument("--weights", default=None,
                    help="npz of ref-name -> array")
    ap.add_argument("--tf-ckpt", default=None,
                    help="TF2 checkpoint dir or prefix (read without "
                         "TensorFlow)")
    ap.add_argument("--mapping", default=None)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = build_config(args.hparams)
    leaves = template_leaves(cfg)

    if args.dump_template:
        template = dump_template(leaves)
        if args.tf_ckpt:
            template = propose_mapping(template,
                                       TFCheckpointSource(args.tf_ckpt))
            n_auto = sum(1 for s in template.values() if s["ref"])
            n_amb = sum(1 for s in template.values()
                        if s.get("auto_ambiguous"))
            print(f"auto-proposed {n_auto}/{len(template)} refs "
                  f"({n_amb} ambiguous — review those)")
        with open(args.dump_template, "w") as f:
            json.dump(template, f, indent=2)
        print(f"wrote {len(template)}-entry template to {args.dump_template}")
        return 0

    if not ((args.weights or args.tf_ckpt) and args.mapping and args.out):
        print("need --weights|--tf-ckpt, --mapping and --out "
              "(or --dump-template)", file=sys.stderr)
        return 1

    with open(args.mapping) as f:
        mapping = json.load(f)
    ref = (TFCheckpointSource(args.tf_ckpt) if args.tf_ckpt
           else dict(np.load(args.weights)))

    state_dict: Dict[str, torch.Tensor] = {}
    missing, mismatched = [], []
    for path, leaf in leaves.items():
        spec = mapping.get(path, {})
        name = spec.get("ref", "")
        if not name:
            missing.append(path)
            continue
        arr = np.asarray(ref[name])
        if spec.get("transpose"):
            arr = np.transpose(arr, spec["transpose"])
        if arr.shape != leaf.shape:
            mismatched.append((path, list(arr.shape), list(leaf.shape)))
            continue
        state_dict[path.replace("/", ".")] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=leaf.dtype))
    if missing or mismatched:
        for p in missing:
            print(f"UNMAPPED: {p}", file=sys.stderr)
        for p, got, want in mismatched:
            print(f"SHAPE MISMATCH: {p} ref{got} != ours{want}",
                  file=sys.stderr)
        return 1

    save_run_dir(args.out, cfg, state_dict)
    print(f"imported {len(state_dict)} tensors into {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
