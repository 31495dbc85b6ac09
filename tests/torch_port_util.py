"""Shared set-up for the tests that hold ``sketchformer_tpu_torch`` to the
JAX package: the same seeded numpy inputs and the same weights go through
both. Weights are the flax initialisation with seeded noise added to every
leaf, so biases and LayerNorm parameters are not at their trivial init."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.convert import params_from_flax
from sketchformer_tpu_torch.models.sketchformer import Sketchformer

RTOL, ATOL = 2e-4, 3e-5     # f32, as tests/test_pallas_encoder.py


def perturb(tree, seed: int, scale: float = 0.05):
    """Flax param tree -> numpy tree with N(0, scale) noise on every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


def small_model_kwargs(**over) -> dict:
    kw = dict(vocab_size=64, num_classes=5, max_len=48, d_model=32,
              num_layers=2, num_heads=4, dff=64, dropout=0.0, lowerdim=16,
              num_queries=2, dtype="float32", attn_impl="xla")
    kw.update(over)
    return kw


def token_batch(cfg, B: int = 4, seed: int = 0, pad_tail: int = 6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (B, cfg.max_len)).astype(np.int32)
    ids[:, cfg.max_len - pad_tail:] = 0
    ids[1, cfg.max_len // 2:] = 0
    return ids


def cont_batch(cfg, B: int = 4, seed: int = 0, pad_tail: int = 6):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((B, cfg.max_len, 3)).astype(np.float32)
    mask = np.ones((B, cfg.max_len), np.float32)
    mask[:, cfg.max_len - pad_tail:] = 0.0
    mask[2, cfg.max_len // 3:] = 0.0
    return rows, mask


def dec_rows(rows):
    """(B, T, 3) stroke rows -> the decoder's (B, T, 5) input rows: dx, dy
    and the one-hot pen state."""
    pen = (rows[..., 2] > 0).astype(np.int64)
    return np.concatenate([rows[..., :2], np.eye(3, dtype=np.float32)[pen]],
                          axis=-1).astype(np.float32)


def jax_model_and_params(seed: int = 0, **over):
    """(flax model, perturbed numpy params) for the small config."""
    cfg = JaxConfig(**small_model_kwargs(**over))
    model = JaxSketchformer(cfg)
    if cfg.use_continuous:
        enc, _ = cont_batch(cfg)
        dec_in = dec_rows(enc)
    else:
        enc = dec_in = token_batch(cfg)
    params = model.init(jax.random.PRNGKey(0), enc, dec_in)["params"]
    return model, perturb(params, seed)


def port_model(jax_model, params) -> Sketchformer:
    cfg = SketchformerConfig(**dataclasses.asdict(jax_model.config))
    model = Sketchformer(cfg)
    state = params_from_flax(params)
    model.load_state_dict(state)
    return model.eval()


def assert_close(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
