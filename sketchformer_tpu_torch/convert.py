"""Weights for the port: from flax params, to and from ``.npz``, or a seeded
initialisation that needs no JAX.

- :func:`params_from_flax` maps a flax param tree (nested dicts of numpy
  arrays) onto the port's ``state_dict``: the key is the flax path joined
  with dots, the layout is unchanged. Subtrees the port has no module for
  yet are returned by name, never dropped silently.
- :func:`save_npz` / :func:`load_npz` keep a ``state_dict`` as a flat npz
  whose keys are the same paths joined with ``/``.
- :func:`init_params` draws every parameter of the port's model from a
  numpy seed with the flax initializers' laws: lecun_normal kernels (a
  normal truncated at two standard deviations, fans as
  ``jax.nn.initializers`` computes them), normal(1/sqrt(d)) token
  embeddings, normal(0.02) bottleneck queries, zero biases, unit
  LayerNorm scales.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from sketchformer_tpu_torch.config import SketchformerConfig

PORTED = ("enc_embed", "encoder", "bottleneck", "classifier")
UNPORTED = ("decoder", "dec_embed", "out_head")

# jax's truncated_normal(-2, 2) has this std; lecun_normal divides it out
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix: Tuple[str, ...]):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(params: Mapping
                     ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Flax ``params`` tree -> ``(state_dict, unported_subtrees)``."""
    sd: Dict[str, torch.Tensor] = {}
    unported: List[str] = []
    for top, sub in params.items():
        if top in UNPORTED:
            unported.append(top)
            continue
        if top not in PORTED:
            raise KeyError(f"unknown flax subtree {top!r}")
        for path, arr in _flatten(sub, (top,)):
            sd[".".join(path)] = torch.from_numpy(
                np.array(arr, dtype=np.float32))
    return sd, sorted(unported)


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    np.savez(path, **{k.replace(".", "/"): v.detach().cpu().float().numpy()
                      for k, v in state_dict.items()})


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k.replace("/", "."): torch.from_numpy(data[k].copy())
                for k in data.files}


def _fans(shape: Tuple[int, ...]) -> Tuple[float, float]:
    """``jax.nn.initializers`` fans: in_axis=-2, out_axis=-1, every other
    axis is receptive field."""
    receptive = int(np.prod(shape)) / shape[-2] / shape[-1]
    return shape[-2] * receptive, shape[-1] * receptive


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x


def init_params(cfg: SketchformerConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded ``state_dict`` for ``Sketchformer(cfg)`` (float32, CPU)."""
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape)
              for k, v in Sketchformer(cfg).state_dict().items()}
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embedding":
            arr = rng.standard_normal(shape) / np.sqrt(cfg.d_model)
        elif leaf == "queries":
            arr = rng.standard_normal(shape) * 0.02
        elif leaf == "kernel":
            fan_in, _ = _fans(shape)
            arr = _truncated_normal(rng, shape) * (
                np.sqrt(1.0 / fan_in) / _TRUNC_STD)
        elif leaf == "scale":
            arr = np.ones(shape)
        elif leaf == "bias":
            arr = np.zeros(shape)
        else:
            raise KeyError(f"no initializer for parameter {name!r}")
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    return sd
