"""Transformer encoder and decoder stacks.

Port of ``sketchformer_tpu/models/transformer.py``: ``FeedForward``,
``EncoderLayer`` / ``DecoderLayer`` (pre-LN and post-LN) and ``Encoder`` /
``Decoder``, with the flax modules' dropout sites (stack entry, each
attention's output, the FFN), active in training mode only. The composed
layers are the CPU oracle. Where the JAX modules take their fused paths
(``attn_impl='pallas'``, pre-LN, no legacy 4-D mask, T <= 1024, and for the
decoder a causal teacher-forced pass), the port runs its kernel stacks:

- ``Encoder``: in eval mode the inference stack (``ops/encoder_stack.py``,
  K1); in training mode the differentiable stack
  (``ops/encoder_stack_train.py``, K3) and then the final LayerNorm.
- ``Decoder``: in eval mode the forward with its final LayerNorm, in
  training mode the differentiable stack (``ops/decoder_stack_train.py``,
  K4) and then the final LayerNorm. Its cached decode step (one position
  per call against a :class:`KVCache` per layer) stays composed; the AR
  decode engine with whole steps in one kernel is ``infer/fast_decode.py``.

In training mode the stack-entry dropout stays a composed site and the
per-layer sites run inside the stacks: on the card each stack draws its
bytes in the kernels from the next seed of ``models/dropout.py``
(``dropout_impl='auto'`` is 'prng' there), on the CPU from the context's
generator ('bits').
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from sketchformer_tpu_torch.convert import stacked_decoder_weights
from sketchformer_tpu_torch.models.attention import KVCache, MultiHeadAttention
from sketchformer_tpu_torch.models.dropout import (
    Dropout,
    current_generator,
    next_seed,
)
from sketchformer_tpu_torch.models.layers import Dense, LayerNorm
from sketchformer_tpu_torch.ops import decoder_stack_train as dst
from sketchformer_tpu_torch.ops import encoder_stack_train as est
from sketchformer_tpu_torch.ops.encoder_stack import (
    MAX_FUSED_LEN,
    fused_encoder_stack,
    stack_encoder_weights,
)
from sketchformer_tpu_torch.utils.engines import note_engine


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dff: int,
                 dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0) -> None:
        super().__init__()
        # flax names the two Dense layers "in" and "out"
        self.add_module("in", Dense(d_model, dff, dtype))
        self.out = Dense(dff, d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.out(torch.relu(getattr(self, "in")(x))))


class EncoderLayer(nn.Module):
    def __init__(self, num_heads: int, d_model: int, dff: int,
                 dtype: torch.dtype = torch.float32, norm_first: bool = True,
                 qk_norm: bool = False, dropout: float = 0.0) -> None:
        super().__init__()
        self.norm_first = norm_first
        self.ln1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, qk_norm,
                                            dropout=dropout)
        self.ln2 = LayerNorm(d_model, dtype)
        self.ffn = FeedForward(d_model, dff, dtype, dropout)

    def forward(self, x, mask=None, key_mask=None):
        if self.norm_first:
            h = self.ln1(x)
            x = x + self.self_attn(h, h, mask=mask, key_mask=key_mask)
            return x + self.ffn(self.ln2(x))
        x = self.ln1(x + self.self_attn(x, x, mask=mask, key_mask=key_mask))
        return self.ln2(x + self.ffn(x))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, num_heads: int, d_model: int,
                 dff: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla", norm_first: bool = True,
                 qk_norm: bool = False, dropout: float = 0.0) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm_first = norm_first
        self.qk_norm = qk_norm
        self.dropout = dropout
        self.drop = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                num_heads, d_model, dff, dtype, norm_first, qk_norm, dropout))
        if norm_first:
            self.ln_out = LayerNorm(d_model, dtype)

    def stacked_weights(self, grad: bool = False) -> dict:
        """Kernel operands for the fused stacks; ``grad=True`` keeps the
        graph back to the parameters (training)."""
        return stack_encoder_weights(
            self.state_dict(keep_vars=grad), num_layers=self.num_layers,
            compute_dtype=self.dtype, grad=grad)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = x.shape[1]
        if self.attn_impl == "pallas":
            if self.norm_first and mask is None and T <= MAX_FUSED_LEN:
                return self._fused_stack(x, key_mask)
            why = ("post-LN config" if not self.norm_first
                   else "structured mask" if mask is not None
                   else f"T={T} > fused limit {MAX_FUSED_LEN}")
            note_engine("encoder-stack", "composed", why)
        x = self.drop(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask=mask, key_mask=key_mask)
        if self.norm_first:
            x = self.ln_out(x)
        return x

    def _fused_stack(self, x, key_mask):
        if not self.training:
            # forward-only inference kernels (eval / embed)
            return fused_encoder_stack(
                x, key_mask, self.stacked_weights(),
                num_heads=self.num_heads, qk_norm=self.qk_norm)
        x = self.drop(x)
        w = self.stacked_weights(grad=True)
        y = est.fused_encoder_stack_train(
            x, key_mask, w, num_heads=self.num_heads, qk_norm=self.qk_norm,
            dropout_rate=self.dropout, generator=current_generator(),
            seed=next_seed() if x.is_cuda else None)
        return est.apply_final_ln(y, w)


class DecoderLayer(nn.Module):
    """Causal self-attention (``attn_impl`` in decode), cross-attention to
    the bottleneck memory (always the composed math, as in flax), FFN."""

    def __init__(self, num_heads: int, d_model: int, dff: int,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 norm_first: bool = True, qk_norm: bool = False,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.norm_first = norm_first
        self.ln1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype,
                                            qk_norm, attn_impl, dropout)
        self.ln2 = LayerNorm(d_model, dtype)
        self.cross_attn = MultiHeadAttention(num_heads, d_model, dtype,
                                             qk_norm, dropout=dropout)
        self.ln3 = LayerNorm(d_model, dtype)
        self.ffn = FeedForward(d_model, dff, dtype, dropout)

    def forward(self, x, memory, self_key_mask=None, causal=False,
                cross_key_mask=None, cache: Optional[KVCache] = None):
        def self_attn(h):
            return self.self_attn(h, h, key_mask=self_key_mask,
                                  causal=causal, cache=cache)

        if self.norm_first:
            x = x + self_attn(self.ln1(x))
            x = x + self.cross_attn(self.ln2(x), memory,
                                    key_mask=cross_key_mask)
            return x + self.ffn(self.ln3(x))
        x = self.ln1(x + self_attn(x))
        x = self.ln2(x + self.cross_attn(x, memory, key_mask=cross_key_mask))
        return self.ln3(x + self.ffn(x))


class Decoder(nn.Module):
    def __init__(self, num_layers: int, num_heads: int, d_model: int,
                 dff: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla", norm_first: bool = True,
                 qk_norm: bool = False, dropout: float = 0.0) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm_first = norm_first
        self.qk_norm = qk_norm
        self.dropout = dropout
        self.drop = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                num_heads, d_model, dff, dtype, attn_impl, norm_first,
                qk_norm, dropout))
        if norm_first:
            self.ln_out = LayerNorm(d_model, dtype)

    def stacked_weights(self, grad: bool = False) -> dict:
        """Kernel operands for ``ops/decode_chunk.py`` and the fused
        stacks (pre-LN only); ``grad=True`` keeps the graph back to the
        parameters (training)."""
        return stacked_decoder_weights(
            self.state_dict(keep_vars=grad), num_layers=self.num_layers,
            compute_dtype=self.dtype, grad=grad)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_key_mask: Optional[torch.Tensor] = None,
                causal: bool = False,
                cross_key_mask: Optional[torch.Tensor] = None,
                caches: Optional[List[KVCache]] = None) -> torch.Tensor:
        """Teacher-forced (``caches`` None) or one cached decode step
        (``caches``: one :class:`KVCache` per layer)."""
        T = x.shape[1]
        if caches is None and self.attn_impl == "pallas":
            if self.norm_first and causal and T <= MAX_FUSED_LEN:
                return self._fused_stack(x, memory, self_key_mask,
                                         cross_key_mask)
            why = ("post-LN config" if not self.norm_first
                   else "non-causal self-attention" if not causal
                   else f"T={T} > fused limit {MAX_FUSED_LEN}")
            note_engine("decoder-stack", "composed", why)
        if caches is None:
            x = self.drop(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(
                x, memory, self_key_mask=self_key_mask, causal=causal,
                cross_key_mask=cross_key_mask,
                cache=None if caches is None else caches[i])
        if self.norm_first:
            x = self.ln_out(x)
        return x

    def _fused_stack(self, x, memory, self_key_mask, cross_key_mask):
        if not self.training:
            # forward-only kernels with the final LayerNorm (eval loss)
            return dst.fused_decoder_stack(
                x, memory, self_key_mask, cross_key_mask,
                self.stacked_weights(), num_heads=self.num_heads,
                qk_norm=self.qk_norm)
        x = self.drop(x)
        w = self.stacked_weights(grad=True)
        y = dst.fused_decoder_stack_train(
            x, memory, self_key_mask, cross_key_mask, w,
            num_heads=self.num_heads, qk_norm=self.qk_norm,
            dropout_rate=self.dropout, generator=current_generator(),
            seed=next_seed() if x.is_cuda else None)
        return est.apply_final_ln(y, w)
