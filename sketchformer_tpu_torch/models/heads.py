"""Output heads: token logits, MDN parameters, classifier on z.

Port of ``sketchformer_tpu/models/heads.py``: each head is Dense layers in
the compute dtype with f32 output whatever the trunk dtype; the classifier
has a dropout site after its hidden ReLU (training mode only).
``TokenHead.fused_ce`` is the token-mode loss head: the masked-mean CE and
accuracy without a (B, T, V) f32 logits tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sketchformer_tpu_torch.models.dropout import Dropout
from sketchformer_tpu_torch.models.layers import Dense
from sketchformer_tpu_torch.ops.token_ce import token_ce_rows


class ClassifierHead(nn.Module):
    def __init__(self, num_classes: int, in_features: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.fc1 = Dense(in_features, hidden, dtype)
        self.drop = Dropout(dropout)
        self.fc2 = Dense(hidden, num_classes, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.drop(torch.relu(self.fc1(z)))).float()


class TokenHead(nn.Module):
    """Decoder output -> (..., vocab_size) f32 logits."""

    def __init__(self, vocab_size: int, d_model: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.proj = Dense(d_model, vocab_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).float()

    def fused_ce(self, x: torch.Tensor, targets: torch.Tensor,
                 pad_id: int = 0, target_chunk: int = 16,
                 row_weights: Optional[torch.Tensor] = None,
                 impl: str = "xla"):
        """(masked-mean CE, accuracy) of ``x`` (B, T, d) against ``targets``
        (B, T) over non-PAD positions, ``row_weights`` (B,) zeroing whole
        rows (``batch["is_real"]``), without the (B, T, V) f32 logits.

        ``impl='pallas'``: ``ops/token_ce.py`` (K6), per-row (ll, corr) on
        the kernels and the masked mean here. ``impl='xla'``: the composed
        oracle, chunked over T: each chunk's logits come from ``proj`` in
        the compute dtype (rounded there, as flax rounds them) and live
        only inside a checkpointed segment while gradients are on.
        """
        B, T, d = x.shape
        if impl == "pallas":
            ll, corr = token_ce_rows(x.reshape(B * T, d), self.proj.kernel,
                                     self.proj.bias, targets.reshape(B * T))
            m = (targets != pad_id).float()
            if row_weights is not None:
                m = m * row_weights.float()[:, None]
            mf = m.reshape(B * T)
            denom = torch.clamp(mf.sum(), min=1.0)
            return -(ll * mf).sum() / denom, (corr * mf).sum() / denom
        chunk = min(target_chunk, T)
        while T % chunk:
            chunk -= 1

        def piece(hc, tc):
            logits = self.proj(hc).float()                     # (B, C, V)
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, tc.long()[..., None])[..., 0] - lse
            corr = (logits.argmax(dim=-1) == tc).float()
            m = (tc != pad_id).float()
            if row_weights is not None:
                m = m * row_weights.float()[:, None]
            return (ll * m).sum(), (corr * m).sum(), m.sum()

        ll_s = acc_s = cnt = 0.0
        for i in range(T // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            if torch.is_grad_enabled():
                a, b, c = checkpoint(piece, x[:, sl], targets[:, sl],
                                     use_reentrant=False)
            else:
                a, b, c = piece(x[:, sl], targets[:, sl])
            ll_s, acc_s, cnt = ll_s + a, acc_s + b, cnt + c
        denom = torch.clamp(cnt, min=1.0)
        return -ll_s / denom, acc_s / denom


class MDNHead(nn.Module):
    """Decoder output -> (..., 6M+3) f32 raw MDN parameters (layout in
    ``ops/mdn.py``)."""

    def __init__(self, num_mixtures: int, d_model: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.proj = Dense(d_model, 6 * num_mixtures + 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).float()
