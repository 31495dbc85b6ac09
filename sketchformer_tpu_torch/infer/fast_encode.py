"""Fast embedding extraction: the encoder stack on the hand-written kernels.

Port of ``sketchformer_tpu/infer/fast_encode.py``. The embedding lookup and
the bottleneck pooling stay plain torch (a gather and a 4-query attention);
the L-layer encoder runs through ``ops.encoder_stack.fused_encoder_stack``.
Declined configurations are the ones the JAX engine declines, logged once
through ``note_engine``, and served by the composed model instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sketchformer_tpu_torch.utils.engines import note_engine
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops.encoder_stack import (
    MAX_FUSED_LEN,
    fused_encoder_stack,
)


def fast_path_support(model: Sketchformer):
    """(supported, reason-declined) for the fused embed engine."""
    cfg = model.config
    if not cfg.norm_first:
        return False, "post-LN config"
    if cfg.max_len > MAX_FUSED_LEN:
        return False, f"max_len={cfg.max_len} > fused limit {MAX_FUSED_LEN}"
    if cfg.d_model % cfg.num_heads:
        return False, "d_model not divisible by num_heads"
    return True, ""


def supports_fast_path(model: Sketchformer) -> bool:
    return fast_path_support(model)[0]


def fast_embed(model: Sketchformer, enc: torch.Tensor,
               enc_mask: Optional[torch.Tensor] = None,
               weights: Optional[dict] = None) -> torch.Tensor:
    """Drop-in for ``model.embed(enc, enc_mask)``; ``weights`` are the
    stacked encoder operands (built from the model when None)."""
    ok, why = fast_path_support(model)
    if not ok:
        note_engine("embed", "composed", why)
        return model.embed(enc, enc_mask)
    note_engine("embed", "fused-encoder-kernel")
    cfg = model.config
    key_mask = model.enc_key_mask(enc, enc_mask)
    if weights is None:
        weights = model.encoder.stacked_weights()
    enc_out = fused_encoder_stack(
        model.embed_input(enc), key_mask, weights, num_heads=cfg.num_heads,
        qk_norm=cfg.qk_norm)
    return model.bottleneck.pooled_z(enc_out, key_mask).float()


def make_fast_embed_fn(model: Sketchformer) -> Callable:
    """``embed(enc, enc_mask=None) -> (B, lowerdim)`` with the stacked
    weights built once (the model is frozen while the function lives)."""
    weights = (model.encoder.stacked_weights()
               if supports_fast_path(model) else None)

    @torch.inference_mode()
    def embed(enc, enc_mask=None):
        return fast_embed(model, enc, enc_mask, weights)

    return embed
