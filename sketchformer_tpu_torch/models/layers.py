"""The flax building blocks the JAX model uses, as torch modules.

Parameters keep flax's names and layouts (``Dense.kernel`` is ``(in, out)``,
``LayerNorm`` has ``scale`` / ``bias``, ``Embed`` has ``embedding``), so a
flax param tree maps onto a ``state_dict`` by joining its path with dots
(``convert.params_from_flax``). Parameters are stored in float32 and cast
to the compute dtype at use, as flax's ``dtype=`` argument does.

Modules are created with zero weights (unit LayerNorm scales); real weights
come from ``convert.init_params`` or a converted checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

LN_EPS = 1e-6  # flax nn.LayerNorm default


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics.

    ``var = max(E[x^2] - mu^2, 0)`` (flax's fast variance, and the TPU
    kernel's ``_ln``); the result is cast to ``out_dtype``.
    """
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    y = (x32 - mu) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(out_dtype)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias`` in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` (eps 1e-6, f32 statistics)."""

    def __init__(self, features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.dtype)


class Embed(nn.Module):
    """``flax.linen.Embed``: a table lookup in the compute dtype."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[ids]
