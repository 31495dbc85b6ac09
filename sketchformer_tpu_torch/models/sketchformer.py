"""The Sketchformer model: embedding -> encoder -> bottleneck z -> decoder +
output head, and the classifier on z.

Port of ``sketchformer_tpu/models/sketchformer.py``: ``encode`` / ``embed``,
the teacher-forced ``forward`` (the flax ``__call__``; in training mode it
is the flax call with ``deterministic=False``: every dropout site is active,
and the fused stacks take their differentiable kernels), the token-mode
loss forward ``forward_tok_loss`` (the CE inside the model, through
``TokenHead.fused_ce``), ``memory_from_z``, and the cached AR step
``decode_step`` with ``init_cache``. Submodule and
parameter names follow the flax module, so ``state_dict`` keys are the flax
param paths joined with dots. Serving paths run the model in eval mode,
where dropout is the identity.
The port's decode cache is exactly as long as it is asked to be: the JAX
model's ``CACHE_PAD`` works around a TPU runtime fault and is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.models.attention import (
    KVCache,
    key_mask_from_float,
    key_mask_from_ids,
)
from sketchformer_tpu_torch.models.bottleneck import Bottleneck
from sketchformer_tpu_torch.models.embeddings import ContinuousEmbed, TokenEmbed
from sketchformer_tpu_torch.models.heads import (
    ClassifierHead,
    MDNHead,
    TokenHead,
)
from sketchformer_tpu_torch.models.transformer import Decoder, Encoder


class Sketchformer(nn.Module):
    def __init__(self, config: SketchformerConfig) -> None:
        super().__init__()
        cfg = config
        dt = cfg.compute_dtype
        self.config = cfg
        if cfg.use_continuous:
            self.enc_embed = ContinuousEmbed(cfg.d_model, cfg.max_len, 3, dt)
            # decoder rows: dx, dy and the one-hot pen state
            self.dec_embed = ContinuousEmbed(cfg.d_model, cfg.max_len, 5, dt)
            self.out_head = MDNHead(cfg.num_mixtures, cfg.d_model, dt)
        else:
            self.enc_embed = TokenEmbed(cfg.vocab_size, cfg.d_model,
                                        cfg.max_len, dt)
            self.dec_embed = TokenEmbed(cfg.vocab_size, cfg.d_model,
                                        cfg.max_len, dt)
            self.out_head = TokenHead(cfg.vocab_size, cfg.d_model, dt)
        self.encoder = Encoder(cfg.num_layers, cfg.num_heads, cfg.d_model,
                               cfg.dff, dt, cfg.attn_impl, cfg.norm_first,
                               cfg.qk_norm, cfg.dropout)
        self.bottleneck = Bottleneck(cfg.bottleneck_mode, cfg.lowerdim,
                                     cfg.num_queries, cfg.d_model,
                                     cfg.num_heads, dt, cfg.dropout)
        self.decoder = Decoder(cfg.num_layers, cfg.num_heads, cfg.d_model,
                               cfg.dff, dt, cfg.attn_impl, cfg.norm_first,
                               cfg.qk_norm, cfg.dropout)
        self.classifier = ClassifierHead(cfg.num_classes, cfg.lowerdim,
                                         cfg.lowerdim, dt, cfg.dropout)

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

    def memory_from_z(self, z: torch.Tensor) -> torch.Tensor:
        """Decoder memory from a stored embedding (decode-from-z path)."""
        return self.bottleneck.expand_z(z)

    def embed_dec(self, dec_in: torch.Tensor,
                  pos: Optional[int] = None) -> torch.Tensor:
        if self.config.use_continuous:
            dec_in = dec_in.to(self.config.compute_dtype)
        return self.dec_embed(dec_in, pos)

    def _trunk(self, enc, dec_in, enc_mask, dec_key_mask):
        """The shared encode -> decode trunk: (z, decoder output)."""
        z, memory, memory_mask = self.encode(enc, enc_mask)
        if self.config.use_continuous:
            self_key = (None if dec_key_mask is None
                        else key_mask_from_float(dec_key_mask))
        else:
            self_key = key_mask_from_ids(dec_in)
        dec_out = self.decoder(self.embed_dec(dec_in), memory,
                               self_key_mask=self_key, causal=True,
                               cross_key_mask=memory_mask)
        return z, dec_out

    def forward(self, enc: torch.Tensor, dec_in: torch.Tensor,
                enc_mask: Optional[torch.Tensor] = None,
                dec_key_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced pass: ``recon`` (token logits or raw MDN
        parameters, f32), ``cls`` logits and the f32 ``embedding``."""
        z, dec_out = self._trunk(enc, dec_in, enc_mask, dec_key_mask)
        return {"recon": self.out_head(dec_out), "cls": self.classify(z),
                "embedding": z.float()}

    def forward_tok_loss(self, enc: torch.Tensor, dec_in: torch.Tensor,
                         dec_tgt: torch.Tensor,
                         enc_mask: Optional[torch.Tensor] = None,
                         dec_key_mask: Optional[torch.Tensor] = None,
                         pad_id: int = 0,
                         row_weights: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
        """Token-mode forward with the reconstruction CE computed inside
        the model (``TokenHead.fused_ce``; the kernels of ``ops/token_ce.py``
        when ``attn_impl='pallas'``, the chunked composed head otherwise),
        so the (B, T, V) f32 logits never exist: ``recon_loss`` and
        ``recon_acc`` scalars, ``cls`` logits and the f32 ``embedding``.
        ``row_weights`` (B,) zeroes repeat-padded rows out of the CE."""
        if self.config.use_continuous:
            raise ValueError("forward_tok_loss is token-mode only")
        z, dec_out = self._trunk(enc, dec_in, enc_mask, dec_key_mask)
        recon_loss, recon_acc = self.out_head.fused_ce(
            dec_out, dec_tgt, pad_id=pad_id, row_weights=row_weights,
            impl="pallas" if self.config.attn_impl == "pallas" else "xla")
        return {"recon_loss": recon_loss, "recon_acc": recon_acc,
                "cls": self.classify(z), "embedding": z.float()}

    def init_cache(self, batch_size: int,
                   max_len: Optional[int] = None) -> List[KVCache]:
        """Zeroed self-attention caches, one per decoder layer, of
        ``max_len`` (default ``config.max_len``) positions."""
        cfg = self.config
        dev = next(self.parameters()).device
        shape = (batch_size * cfg.num_heads, max_len or cfg.max_len,
                 cfg.d_model // cfg.num_heads)
        return [KVCache(torch.zeros(shape, dtype=cfg.compute_dtype,
                                    device=dev),
                        torch.zeros(shape, dtype=cfg.compute_dtype,
                                    device=dev))
                for _ in range(cfg.num_layers)]

    def decode_step(self, dec_in_t: torch.Tensor, memory: torch.Tensor,
                    memory_mask: Optional[torch.Tensor], t: int,
                    cache: List[KVCache]) -> torch.Tensor:
        """One AR step at position ``t``: ``dec_in_t`` is (B, 1) token ids
        or (B, 1, 5) stroke rows; appends to ``cache`` and returns the head
        output for the new position, (B, 1, ...) f32."""
        x = self.embed_dec(dec_in_t, pos=t)
        return self.out_head(self.decoder(x, memory,
                                          cross_key_mask=memory_mask,
                                          caches=cache))
