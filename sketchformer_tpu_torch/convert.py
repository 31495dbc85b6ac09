"""Weights for the port: from flax params, to and from ``.npz``, or a seeded
initialisation that needs no JAX.

- :func:`params_from_flax` maps a flax param tree (nested dicts of numpy
  arrays) onto the port's ``state_dict``: the key is the flax path joined
  with dots, the layout is unchanged (``HeadProjection`` kernels stay
  ``(d, H, Dh)``, ``HeadOutProjection`` kernels ``(H, Dh, d)``). A JAX
  gradient tree has the params' structure and maps the same way, which is
  how the tests hold the port's gradients to the JAX package's;
  :func:`params_to_flax` is the inverse (a ``state_dict`` or the port's
  gradients -> a nested dict of numpy arrays).
- :func:`save_npz` / :func:`load_npz` keep a ``state_dict`` as a flat npz
  whose keys are the same paths joined with ``/``.
- :func:`init_params` draws every parameter of the port's model from a
  numpy seed with the flax initializers' laws: lecun_normal kernels (a
  normal truncated at two standard deviations, fans as
  ``jax.nn.initializers`` computes them), normal(1/sqrt(d)) token
  embeddings, normal(0.02) bottleneck queries, zero biases, unit
  LayerNorm scales.
- :func:`stacked_decoder_weights` stacks the decoder's ``state_dict`` into
  the operands of the decode kernels, as the JAX ``stack_decoder_weights``
  does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from sketchformer_tpu_torch.config import SketchformerConfig

PORTED = ("enc_embed", "encoder", "bottleneck", "classifier", "dec_embed",
          "decoder", "out_head")

# jax's truncated_normal(-2, 2) has this std; lecun_normal divides it out
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix: Tuple[str, ...]):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree -> the port's ``state_dict`` (float32, CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for top, sub in params.items():
        if top not in PORTED:
            raise KeyError(f"unknown flax subtree {top!r}")
        for path, arr in _flatten(sub, (top,)):
            sd[".".join(path)] = torch.from_numpy(
                np.array(arr, dtype=np.float32))
    return sd


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``state_dict`` (or a dict of its gradients, same keys) ->
    the flax param tree, nested dicts of float32 numpy arrays."""
    tree: Dict = {}
    for key, value in state_dict.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().float().numpy()
    return tree


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


def stacked_decoder_weights(dec_state: Mapping[str, torch.Tensor], *,
                            num_layers: int, compute_dtype: torch.dtype,
                            grad: bool = False) -> dict:
    """Pre-LN decoder ``state_dict`` (keys ``layer_{i}.…``, ``ln_out.…``) ->
    the stacked operands of ``ops/decode_chunk.py`` and
    ``ops/decoder_stack_train.py``, with the keys of the JAX
    ``stack_decoder_weights``: products' weights (L, K, N) in the compute
    dtype, biases and LayerNorm parameters f32, ``lnfs``/``lnfb`` (1, d),
    and identity qk-norm parameters when the model has no qk-norm.
    ``grad=True`` keeps the autograd graph back to the parameters (pass
    ``state_dict(keep_vars=True)``); otherwise the operands are detached.
    """
    f32 = torch.float32

    def get(i, name):
        t = dec_state[f"layer_{i}.{name}"]
        return t if grad else t.detach()

    def stk(name, dtype, shape=None):
        out = torch.stack([get(i, name).to(dtype) for i in range(num_layers)])
        return (out if shape is None else out.reshape(num_layers, *shape)
                ).contiguous()

    def cat(attn, names, part):
        return torch.stack([torch.cat(
            [get(i, f"{attn}.{n}.{part}").reshape(d, -1) if part == "kernel"
             else get(i, f"{attn}.{n}.{part}").reshape(-1) for n in names],
            dim=-1) for i in range(num_layers)])

    d = dec_state["layer_0.ln1.scale"].shape[0]
    dt = compute_dtype
    qkv, kv = ("query", "key", "value"), ("key", "value")
    w = {
        "ln1s": stk("ln1.scale", f32), "ln1b": stk("ln1.bias", f32),
        "s_wqkv": cat("self_attn", qkv, "kernel").to(dt).contiguous(),
        "s_bqkv": cat("self_attn", qkv, "bias").to(f32).contiguous(),
        "s_wo": stk("self_attn.out.kernel", dt, (-1, d)),
        "s_bo": stk("self_attn.out.bias", f32),
        "ln2s": stk("ln2.scale", f32), "ln2b": stk("ln2.bias", f32),
        "c_wq": stk("cross_attn.query.kernel", dt, (d, -1)),
        "c_bq": stk("cross_attn.query.bias", f32, (-1,)),
        "c_wkv": cat("cross_attn", kv, "kernel").to(dt).contiguous(),
        "c_bkv": cat("cross_attn", kv, "bias").to(f32).contiguous(),
        "c_wo": stk("cross_attn.out.kernel", dt, (-1, d)),
        "c_bo": stk("cross_attn.out.bias", f32),
        "ln3s": stk("ln3.scale", f32), "ln3b": stk("ln3.bias", f32),
        "w1": stk("ffn.in.kernel", dt), "b1": stk("ffn.in.bias", f32),
        "w2": stk("ffn.out.kernel", dt), "b2": stk("ffn.out.bias", f32),
    }
    if "layer_0.self_attn.q_norm.scale" in dec_state:
        for attn, a in (("self_attn", "s"), ("cross_attn", "c")):
            for p, n in (("q", "q_norm"), ("k", "k_norm")):
                w[f"{a}_{p}ns"] = stk(f"{attn}.{n}.scale", f32)
                w[f"{a}_{p}nb"] = stk(f"{attn}.{n}.bias", f32)
    else:
        head_dim = dec_state["layer_0.self_attn.query.kernel"].shape[-1]
        dev = w["ln1s"].device
        for key in ("s_qns", "s_kns", "c_qns", "c_kns"):
            w[key] = torch.ones((num_layers, head_dim), dtype=f32, device=dev)
        for key in ("s_qnb", "s_knb", "c_qnb", "c_knb"):
            w[key] = torch.zeros((num_layers, head_dim), dtype=f32,
                                 device=dev)
    lnf = (dec_state["ln_out.scale"], dec_state["ln_out.bias"])
    if not grad:
        lnf = tuple(t.detach() for t in lnf)
    w["lnfs"] = lnf[0].to(f32).reshape(1, d)
    w["lnfb"] = lnf[1].to(f32).reshape(1, d)
    return w
