"""The Sketchformer model, encoder side: embedding -> encoder -> bottleneck z
-> classifier.

Port of ``sketchformer_tpu/models/sketchformer.py`` (``encode``, ``embed``
and the classifier on z). Submodule and parameter names follow the flax
module, so ``state_dict`` keys are the flax param paths joined with dots.
The decoder, its embedding and the output head come with the training and
decode slices. Inference only: dropout is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.models.attention import (
    key_mask_from_float,
    key_mask_from_ids,
)
from sketchformer_tpu_torch.models.bottleneck import Bottleneck
from sketchformer_tpu_torch.models.embeddings import ContinuousEmbed, TokenEmbed
from sketchformer_tpu_torch.models.heads import ClassifierHead
from sketchformer_tpu_torch.models.transformer import Encoder


class Sketchformer(nn.Module):
    def __init__(self, config: SketchformerConfig) -> None:
        super().__init__()
        cfg = config
        dt = cfg.compute_dtype
        self.config = cfg
        if cfg.use_continuous:
            self.enc_embed = ContinuousEmbed(cfg.d_model, cfg.max_len, 3, dt)
        else:
            self.enc_embed = TokenEmbed(cfg.vocab_size, cfg.d_model,
                                        cfg.max_len, dt)
        self.encoder = Encoder(cfg.num_layers, cfg.num_heads, cfg.d_model,
                               cfg.dff, dt, cfg.attn_impl, cfg.norm_first,
                               cfg.qk_norm)
        self.bottleneck = Bottleneck(cfg.bottleneck_mode, cfg.lowerdim,
                                     cfg.num_queries, cfg.d_model,
                                     cfg.num_heads, dt)
        self.classifier = ClassifierHead(cfg.num_classes, cfg.lowerdim,
                                         cfg.lowerdim, dt)

    def enc_key_mask(self, enc: torch.Tensor,
                     enc_mask: Optional[torch.Tensor]):
        """(B, T) bool key mask (True = attend), or None."""
        if self.config.use_continuous:
            return None if enc_mask is None else key_mask_from_float(enc_mask)
        return key_mask_from_ids(enc)

    def embed_input(self, enc: torch.Tensor) -> torch.Tensor:
        if self.config.use_continuous:
            enc = enc.to(self.config.compute_dtype)
        return self.enc_embed(enc)

    def encode(self, enc: torch.Tensor,
               enc_mask: Optional[torch.Tensor] = None):
        """Sketch batch -> (z, memory, memory_mask); z is the embedding."""
        key_mask = self.enc_key_mask(enc, enc_mask)
        enc_out = self.encoder(self.embed_input(enc), key_mask=key_mask)
        return self.bottleneck(enc_out, key_mask)

    def embed(self, enc: torch.Tensor,
              enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embedding extraction: (B, lowerdim) float32 z."""
        z, _, _ = self.encode(enc, enc_mask)
        return z.float()

    def classify(self, z: torch.Tensor) -> torch.Tensor:
        """Class logits (f32) from embeddings z."""
        return self.classifier(z)
