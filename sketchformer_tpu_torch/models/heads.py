"""Output heads: token logits, MDN parameters, classifier on z.

Port of ``sketchformer_tpu/models/heads.py``: each head is Dense layers in
the compute dtype with f32 output whatever the trunk dtype; the classifier
has a dropout site after its hidden ReLU (training mode only).
``TokenHead.fused_ce`` (token-mode training) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from sketchformer_tpu_torch.models.dropout import Dropout
from sketchformer_tpu_torch.models.layers import Dense


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


class MDNHead(nn.Module):
    """Decoder output -> (..., 6M+3) f32 raw MDN parameters (layout in
    ``ops/mdn.py``)."""

    def __init__(self, num_mixtures: int, d_model: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.proj = Dense(d_model, 6 * num_mixtures + 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).float()
