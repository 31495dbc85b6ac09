"""Classifier head on the bottleneck embedding.

Port of ``sketchformer_tpu/models/heads.py::ClassifierHead``: fc1 -> ReLU ->
fc2, logits in f32 whatever the trunk dtype. (The token and MDN heads come
with the decoder.)
"""

from __future__ import annotations

import torch
from torch import nn

from sketchformer_tpu_torch.models.layers import Dense


class ClassifierHead(nn.Module):
    def __init__(self, num_classes: int, in_features: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.fc1 = Dense(in_features, hidden, dtype)
        self.fc2 = Dense(hidden, num_classes, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(z))).float()
