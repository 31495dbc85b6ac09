"""Fast embedding extraction: the encoder stack on the hand-written kernels.

Port of ``sketchformer_tpu/infer/fast_encode.py``. The embedding lookup and
the bottleneck pooling stay plain torch (a gather and a 4-query attention);
the L-layer encoder runs through ``ops.encoder_stack.fused_encoder_stack``.
Declined configurations are the ones the JAX engine declines, logged once
through ``note_engine``, and served by the composed model instead.

Given the layout of a batch's valid rows (:func:`packed_rows`, built on the
host), the stack runs on those rows alone
(``ops.encoder_stack.fused_encoder_stack_packed``): ``z`` depends on no
other row, and each valid row's output is the padded stack's. Where the
packed stack does not fit (:func:`packed_support`, or a batch
:func:`packed_rows` declines) or a batch is so nearly full that packing
saves nothing (``PACK_MAX_VALID_SHARE``), the padded stack runs, as it
does for a caller that gives no layout.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sketchformer_tpu_torch.utils.engines import note_engine
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops.encoder_stack import (
    MAX_FUSED_LEN,
    PackedRows,
    fused_encoder_stack,
    fused_encoder_stack_packed,
    pack_rows,
    ragged_declines,
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


# the largest share of valid positions at which a batch is packed: above
# it the rows saved no longer pay for the gather, the scatter and the host's
# layout. embed_dataset end to end, packed / padded, at B=2048, T=192,
# tok_h8's widths, bf16, on an NVIDIA H100 80GB HBM3 (700 W): 1.56 at 54.5%
# valid, 1.18 at 75%, 1.00 at 88%, 0.97 at 94%, 0.96 at 100%
PACK_MAX_VALID_SHARE = 0.875


def supports_fast_path(model: Sketchformer) -> bool:
    return fast_path_support(model)[0]


def packed_support(model: Sketchformer, device: torch.device):
    """(supported, reason-declined) for the packed stack on ``device``: the
    fused engine's, and the ragged attention kernel's
    (``ops.encoder_stack.ragged_declines``: a card, bf16, a head_dim that
    is a multiple of 16 up to 128)."""
    ok, why = fast_path_support(model)
    if not ok:
        return ok, why
    cfg = model.config
    why = ragged_declines(device, cfg.compute_dtype,
                          cfg.d_model // cfg.num_heads)
    return not why, why


def packed_rows(model: Sketchformer, enc: np.ndarray,
                enc_mask: Optional[np.ndarray],
                device: torch.device) -> Optional[PackedRows]:
    """The layout of a host batch's valid rows (CPU tensors), by the rule
    of ``Sketchformer.enc_key_mask``; or None where the padded stack serves
    the batch. A model the fused engine declines is noted by
    :func:`fast_embed`. The padded stack is the faster one on the CPU (the
    packed stack's plain attention takes the sketches one at a time) and
    for a batch more than ``PACK_MAX_VALID_SHARE`` valid: noted once at
    INFO. Any other decline, of the model or of the batch, is noted once a
    reason (site ``embed-pack``)."""
    if not fast_path_support(model)[0]:
        return None
    ok, why = packed_support(model, device)
    if ok:
        key_mask = model.enc_key_mask(enc, enc_mask)   # on the numpy arrays
        valid = None if key_mask is None else np.asarray(key_mask, bool)
        if valid is not None and valid.mean() <= PACK_MAX_VALID_SHARE:
            rows, why = pack_rows(valid)
            if not why:
                return rows
    faster = not why or device.type == "cpu"
    note_engine("embed-pack", "padded", "" if faster else why)
    return None


def fast_embed(model: Sketchformer, enc: torch.Tensor,
               enc_mask: Optional[torch.Tensor] = None,
               weights: Optional[dict] = None,
               rows: Optional[PackedRows] = None) -> torch.Tensor:
    """Drop-in for ``model.embed(enc, enc_mask)``; ``weights`` are the
    stacked encoder operands (built from the model when None); ``rows``
    the batch's valid rows (:func:`packed_rows`, tensors on ``enc``'s
    device), or None for the padded stack."""
    ok, why = fast_path_support(model)
    if not ok:
        note_engine("embed", "composed", why)
        return model.embed(enc, enc_mask)
    cfg = model.config
    key_mask = model.enc_key_mask(enc, enc_mask)
    if weights is None:
        weights = model.encoder.stacked_weights()
    kw = dict(num_heads=cfg.num_heads, qk_norm=cfg.qk_norm)
    if rows is not None:
        note_engine("embed", "fused-encoder-kernel-packed")
        enc_out = fused_encoder_stack_packed(model.embed_input(enc), rows,
                                             weights, **kw)
    else:
        note_engine("embed", "fused-encoder-kernel")
        enc_out = fused_encoder_stack(model.embed_input(enc), key_mask,
                                      weights, **kw)
    return model.bottleneck.pooled_z(enc_out, key_mask).float()


def make_fast_embed_fn(model: Sketchformer) -> Callable:
    """``embed(enc, enc_mask=None, rows=None) -> (B, lowerdim)`` with the
    stacked weights built once (the model is frozen while the function
    lives)."""
    weights = (model.encoder.stacked_weights()
               if supports_fast_path(model) else None)

    @torch.inference_mode()
    def embed(enc, enc_mask=None, rows=None):
        return fast_embed(model, enc, enc_mask, weights, rows)

    return embed
