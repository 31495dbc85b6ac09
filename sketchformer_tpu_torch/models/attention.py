"""Multi-head attention (composed path) and key-mask helpers.

Port of ``sketchformer_tpu/models/attention.py``: ``dot_product_attention``
(the plain XLA formulation), the per-head projections with flax-compatible
parameter layouts, and ``MultiHeadAttention`` without its KV-cache decode
branch. Softmax runs in f32 even when activations are bf16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sketchformer_tpu_torch.models.layers import LayerNorm

NEG_INF = -1e9


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, T, H, Dh) tensors; ``mask`` is boolean,
    True = attend, broadcasting against (B, H, Tq, Tk)."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                         device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class HeadProjection(nn.Module):
    """x (..., T, d_in) -> (..., T, H, Dh); kernel (d_in, H, Dh), bias (H, Dh)."""

    def __init__(self, d_in: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(d_in, num_heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(num_heads, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = torch.einsum("...tm,mhd->...thd", x.to(dt), self.kernel.to(dt))
        return out + self.bias.to(dt)


class HeadOutProjection(nn.Module):
    """(..., T, H, Dh) -> (..., T, d); kernel (H, Dh, d), bias (d,)."""

    def __init__(self, num_heads: int, head_dim: int, d_model: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(num_heads, head_dim, d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = torch.einsum("...thd,hdm->...tm", x.to(dt), self.kernel.to(dt))
        return out + self.bias.to(dt)


class MultiHeadAttention(nn.Module):
    """MHA with separate q and kv inputs; ``qk_norm`` applies a LayerNorm
    over head_dim (one (Dh,) scale/bias shared by all heads) to q and k."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 qk_norm: bool = False) -> None:
        super().__init__()
        if d_model % num_heads:
            raise ValueError("num_heads must divide d_model")
        head_dim = d_model // num_heads
        self.num_heads = num_heads
        self.query = HeadProjection(d_model, num_heads, head_dim, dtype)
        self.key = HeadProjection(d_model, num_heads, head_dim, dtype)
        self.value = HeadProjection(d_model, num_heads, head_dim, dtype)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = LayerNorm(head_dim, dtype)
            self.k_norm = LayerNorm(head_dim, dtype)
        self.out = HeadOutProjection(num_heads, head_dim, d_model, dtype)

    def forward(self, q_inp: torch.Tensor, kv_inp: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: legacy 4-D boolean mask; ``key_mask``: (B, Tk) bool.
        Both may be given; they are combined."""
        q = self.query(q_inp)
        k = self.key(kv_inp)
        v = self.value(kv_inp)
        if self.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        full = combine_masks(
            mask, None if key_mask is None else key_mask[:, None, None, :])
        return self.out(dot_product_attention(q, k, v, mask=full))


# ---------------------------------------------------------------------------
# mask builders
# ---------------------------------------------------------------------------


def key_mask_from_ids(ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """(B, T) int tokens -> (B, T) boolean key mask, True = attend."""
    return ids != pad_id


def key_mask_from_float(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) float/bool validity -> (B, T) boolean key mask."""
    return mask > 0.5


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    present = [m for m in masks if m is not None]
    if not present:
        return None
    out = present[0]
    for m in present[1:]:
        out = torch.logical_and(out, m)
    return out
