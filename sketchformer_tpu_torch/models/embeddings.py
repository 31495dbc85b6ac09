"""Input embeddings and sinusoidal positional encoding.

Port of ``sketchformer_tpu/models/embeddings.py``: the token lookup (or the
dense projection of continuous stroke rows) times sqrt(d_model), plus the
sinusoidal table, all in the compute dtype. ``pos`` starts the table at a
given position (one cached AR decode step) instead of at 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from sketchformer_tpu_torch.models.layers import Dense, Embed


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Classic transformer posenc table, shape (max_len, d_model), f32."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    i = np.arange(d_model, dtype=np.float32)[None, :]
    angle_rates = 1.0 / np.power(10000.0, (2 * (i // 2)) / d_model)
    angles = pos * angle_rates
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return table


class _PositionalInput(nn.Module):
    """Shared tail: ``emb * sqrt(d) + table[pos:pos + T]`` in the compute
    dtype (``pos`` 0 when None). sqrt(d) is a 0-d CPU tensor in that dtype,
    not a buffer: a CUDA op takes it as a kernel argument, so the multiply
    copies nothing to the card and never waits on it."""

    def __init__(self, d_model: int, max_len: int, dtype: torch.dtype):
        super().__init__()
        self.d_model = d_model
        self.dtype = dtype
        self.sqrt_d = torch.tensor(np.sqrt(d_model), dtype=dtype)
        self.register_buffer(
            "table",
            torch.from_numpy(sinusoidal_position_encoding(max_len, d_model)),
            persistent=False)

    def _add_positions(self, emb: torch.Tensor,
                       pos: Optional[int] = None) -> torch.Tensor:
        start = pos or 0
        pe = self.table[start:start + emb.shape[-2]]
        return emb * self.sqrt_d + pe.to(self.dtype)


class TokenEmbed(_PositionalInput):
    """Token lookup * sqrt(d_model) + posenc."""

    def __init__(self, vocab_size: int, d_model: int, max_len: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(d_model, max_len, dtype)
        self.embed = Embed(vocab_size, d_model, dtype)

    def forward(self, ids: torch.Tensor,
                pos: Optional[int] = None) -> torch.Tensor:
        return self._add_positions(self.embed(ids), pos)


class ContinuousEmbed(_PositionalInput):
    """Dense projection of stroke rows (3 or 5 features) + posenc."""

    def __init__(self, d_model: int, max_len: int, in_features: int = 3,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(d_model, max_len, dtype)
        self.proj = Dense(in_features, d_model, dtype)

    def forward(self, rows: torch.Tensor,
                pos: Optional[int] = None) -> torch.Tensor:
        return self._add_positions(self.proj(rows), pos)
