"""Multi-head attention (composed path) and key-mask helpers.

Port of ``sketchformer_tpu/models/attention.py``: ``dot_product_attention``
(the plain XLA formulation, or the K8 kernel with ``impl='pallas'``),
``cached_decode_attention``, the per-head projections with
flax-compatible parameter layouts, and ``MultiHeadAttention`` with its
KV-cache decode branch. The cache is an explicit :class:`KVCache` object,
where flax keeps a mutable ``cache`` collection. Softmax runs in f32 even
when activations are bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from sketchformer_tpu_torch.models.dropout import Dropout
from sketchformer_tpu_torch.models.layers import LayerNorm
from sketchformer_tpu_torch.ops.decode_attention import decode_attention
from sketchformer_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e9


def _scale(q: torch.Tensor) -> torch.Tensor:
    """1/sqrt(Dh) computed in f32 as ``jnp.sqrt`` does, in q's dtype, as a
    0-d CPU tensor: a CUDA op takes it as a kernel argument, with no copy
    to the card and no wait on it."""
    depth = np.float32(q.shape[-1])
    return torch.tensor(float(np.float32(1.0) / np.sqrt(depth)),
                        dtype=q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "xla") -> torch.Tensor:
    """Attention over (B, T, H, Dh) tensors; ``mask`` is boolean,
    True = attend, broadcasting against (B, H, Tq, Tk). ``impl='pallas'``
    runs :func:`flash_attention` (K8), ``'xla'`` the composed math."""
    if impl == "pallas":
        return flash_attention(q, k, v, mask=mask)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    logits = torch.einsum("bqhd,bkhd->bhqk", q * _scale(q), k).float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def cached_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, cache_len: int,
                            impl: str = "xla") -> torch.Tensor:
    """Attention of (B*H, Tq, Dh) queries against head-folded (B*H, Tmax,
    Dh) caches whose first ``cache_len`` positions are filled.
    ``impl='pallas'`` runs the decode-attention kernel
    (``ops/decode_attention.py``); ``'xla'`` the plain composed math."""
    if impl == "pallas":
        return decode_attention(q, k_cache, v_cache, cache_len)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    logits = torch.einsum("bqd,bkd->bqk", q * _scale(q), k_cache).float()
    filled = torch.arange(k_cache.shape[1], device=q.device) < cache_len
    logits = torch.where(filled[None, None, :], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", weights, v_cache)


@dataclasses.dataclass
class KVCache:
    """One self-attention layer's decode cache: head-folded (B*H, Tmax, Dh)
    keys and values in the compute dtype, and the number of filled
    positions."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0


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
    over head_dim (one (Dh,) scale/bias shared by all heads) to q and k.
    ``attn_impl='pallas'`` runs the full-sequence branch on
    :func:`flash_attention` (K8) with the structured masks, and the decode
    branch on :func:`cached_decode_attention`'s kernel (K12); ``'xla'`` the
    composed math of both. ``dropout`` is the rate of the site after the
    output projection (training mode only)."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 qk_norm: bool = False, attn_impl: str = "xla",
                 dropout: float = 0.0) -> None:
        super().__init__()
        if d_model % num_heads:
            raise ValueError("num_heads must divide d_model")
        head_dim = d_model // num_heads
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.attn_impl = attn_impl
        self.query = HeadProjection(d_model, num_heads, head_dim, dtype)
        self.key = HeadProjection(d_model, num_heads, head_dim, dtype)
        self.value = HeadProjection(d_model, num_heads, head_dim, dtype)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = LayerNorm(head_dim, dtype)
            self.k_norm = LayerNorm(head_dim, dtype)
        self.out = HeadOutProjection(num_heads, head_dim, d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, q_inp: torch.Tensor, kv_inp: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                causal: bool = False,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        """``mask``: legacy 4-D boolean mask; ``key_mask``: (B, Tk) bool;
        ``causal``: the look-ahead mask. They are combined (the K8 kernel
        applies ``key_mask`` and ``causal`` without a (Tq, Tk) mask, and a
        legacy ``mask`` given with them has them folded in, as flax does).
        With ``cache`` (decode), kv_inp's positions are appended to the
        cache and q attends to every filled position; the masks are not
        used."""
        q = self.query(q_inp)
        k = self.key(kv_inp)
        v = self.value(kv_inp)
        if self.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if cache is not None:
            B, H, Dh = q.shape[0], self.num_heads, self.head_dim

            def fold(x):   # (B, T, H, Dh) -> (B*H, T, Dh)
                return x.transpose(1, 2).reshape(B * H, x.shape[1], Dh)

            start = cache.index
            cache.index = start + k.shape[1]
            cache.k[:, start:cache.index] = fold(k)
            cache.v[:, start:cache.index] = fold(v)
            out = cached_decode_attention(fold(q), cache.k, cache.v,
                                          cache.index, impl=self.attn_impl)
            out = out.reshape(B, H, q.shape[1], Dh).transpose(1, 2)
        elif self.attn_impl == "pallas" and mask is None:
            out = flash_attention(q, k, v, key_mask=key_mask, causal=causal)
        else:
            full = combine_masks(
                mask,
                None if key_mask is None else key_mask[:, None, None, :],
                causal_mask(q.shape[1], q.device) if causal else None)
            out = dot_product_attention(q, k, v, mask=full,
                                        impl=self.attn_impl)
        return self.drop(self.out(out))


# ---------------------------------------------------------------------------
# mask builders
# ---------------------------------------------------------------------------


def key_mask_from_ids(ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """(B, T) int tokens -> (B, T) boolean key mask, True = attend."""
    return ids != pad_id


def key_mask_from_float(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) float/bool validity -> (B, T) boolean key mask."""
    return mask > 0.5


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) boolean look-ahead mask, True = attend."""
    return torch.ones((length, length), dtype=torch.bool,
                      device=device).tril()[None, None]


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    present = [m for m in masks if m is not None]
    if not present:
        return None
    out = present[0]
    for m in present[1:]:
        out = torch.logical_and(out, m)
    return out
