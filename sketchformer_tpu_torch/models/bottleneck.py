"""Self-attention bottleneck: variable-length encoding -> fixed-length z.

Port of ``sketchformer_tpu/models/bottleneck.py`` with its three modes:

- ``attn``   learned-query attention pooling (the paper's best; default)
- ``mean``   masked mean pooling + projection
- ``direct`` the decoder would cross-attend the full encoder memory; z is
             still a pooled projection so the embedding API stays uniform

``forward`` returns ``(z, memory, memory_mask)``; for attn/mean the memory
is re-expanded from z (``expand_z``). ``pool_attn`` has no qk-norm and
always runs the composed path: its queries are only ``num_queries`` rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sketchformer_tpu_torch.models.attention import MultiHeadAttention
from sketchformer_tpu_torch.models.layers import Dense


class Bottleneck(nn.Module):
    def __init__(self, mode: str = "attn", lowerdim: int = 256,
                 num_queries: int = 4, d_model: int = 256, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.mode = mode
        self.num_queries = num_queries
        self.d_model = d_model
        self.dtype = dtype
        if mode == "attn":
            self.queries = nn.Parameter(torch.zeros(num_queries, d_model))
            self.pool_attn = MultiHeadAttention(num_heads, d_model, dtype,
                                                dropout=dropout)
            self.to_z = Dense(num_queries * d_model, lowerdim, dtype)
        elif mode in ("mean", "direct"):
            self.to_z = Dense(d_model, lowerdim, dtype)
        else:
            raise ValueError(f"unknown bottleneck mode {mode!r}")
        if mode != "direct":
            self.expand = Dense(lowerdim, num_queries * d_model, dtype)

    def expand_z(self, z: torch.Tensor) -> torch.Tensor:
        """Fixed-length embedding -> decoder memory (B, num_queries, d)."""
        if self.mode == "direct":
            raise ValueError("direct mode has no z->memory expansion")
        return self.expand(z.to(self.dtype)).reshape(
            z.shape[0], self.num_queries, self.d_model)

    def pooled_z(self, enc_out: torch.Tensor,
                 enc_key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The z branch alone: (B, T, d) encoder output -> (B, lowerdim)."""
        B = enc_out.shape[0]
        if self.mode == "attn":
            q = self.queries.to(self.dtype).expand(
                B, self.num_queries, self.d_model)
            pooled = self.pool_attn(q, enc_out, key_mask=enc_key_mask)
            return self.to_z(pooled.reshape(B, self.num_queries * self.d_model))
        if enc_key_mask is not None:
            m = enc_key_mask[:, :, None].to(enc_out.dtype)
            denom = torch.clamp(m.sum(dim=1), min=1.0)
            pooled = (enc_out * m).sum(dim=1) / denom
        else:
            pooled = enc_out.mean(dim=1)
        return self.to_z(pooled)

    def forward(self, enc_out: torch.Tensor,
                enc_key_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        z = self.pooled_z(enc_out, enc_key_mask)
        if self.mode == "direct":
            return z, enc_out, enc_key_mask
        return z, self.expand_z(z), None  # all memory slots valid
