"""The port's config mirrors the JAX one, and the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from sketchformer_tpu.models.sketchformer import SketchformerConfig as JaxConfig
from sketchformer_tpu_torch.config import SketchformerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fields_and_defaults_match_jax_config():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(SketchformerConfig) == spec(JaxConfig)


def test_from_hparams_round_trip():
    hps = SketchformerConfig.default_hparams()
    hps.parse("d_model=64,num_heads=4,dtype=bfloat16,qk_norm=true")
    cfg = SketchformerConfig.from_hparams(hps)
    assert (cfg.d_model, cfg.num_heads, cfg.qk_norm) == (64, 4, True)
    assert cfg.compute_dtype == torch.bfloat16
    assert SketchformerConfig().compute_dtype == torch.float32
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        SketchformerConfig(dtype="int8").compute_dtype


def test_port_imports_and_embeds_without_jax():
    """A fresh interpreter imports every port module and runs a CPU embed
    through the CLI path; neither jax nor flax ends up in sys.modules."""
    code = """
import sys
import numpy as np
import sketchformer_tpu_torch
from sketchformer_tpu_torch import cli, convert, config
from sketchformer_tpu_torch.infer import encode, fast_encode
from sketchformer_tpu_torch.models import (attention, bottleneck, embeddings,
                                           heads, layers, sketchformer,
                                           transformer)
from sketchformer_tpu_torch.ops import _build, encoder_stack
args = cli.build_parser().parse_args([
    "embed", "--loader", "synthetic", "--device", "cpu", "--init-seed", "0",
    "--loader-arg", "num_classes=4", "--loader-arg", "batch_size=8",
    "--loader-arg", "buckets=[64]",
    "--hparams", "d_model=32,num_layers=1,num_heads=4,dff=64,lowerdim=16,"
                 "max_len=64,attn_impl=pallas"])
model, loader = cli.build_model_and_loader(args)
Z, labels = encode.embed_dataset(model, loader.get_validation_set(2))
assert Z.shape == (16, 16) and np.isfinite(Z).all(), Z.shape
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
