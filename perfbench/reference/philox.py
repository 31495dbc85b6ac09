"""The dropout draw of the training cells, in plain torch.

A frozen copy of the arithmetic the program's training step draws its
dropout bytes with, so that the reference can apply the same masks:

- each dropout call of a step takes a 64-bit seed derived on the host from
  (run seed, step, microbatch) and the call's index in the step:
  ``SeedSequence([seed, step, micro, index]).generate_state(1, uint64)``;
- the byte of element (batch row b, position t, column c) of site k of
  layer l is byte k of the Philox-4x32-10 word number idx = t * d + c of
  stream l * 2**20 + b: ``Philox(key=seed, counter=(idx >> 2, stream, 0,
  0))[idx & 3]``;
- an element is kept when its byte is >= round(rate * 256), and a kept
  value is divided by 1 - thresh / 256.

A composed dropout site (a stack's entry, the bottleneck's pooling, the
classifier) is layer 0, site 0 of its own seed, with x viewed as (rows,
positions, columns); a fused stack takes one seed for all its layers and
sites.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

LAYER_STRIDE = 1 << 20
_M0, _M1 = 0xD2511F53, 0xCD9E8D57     # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85     # Weyl key increments
_MASK = 0xFFFFFFFF


def call_seed(key: Sequence[int], index: int) -> int:
    """The 64-bit seed of dropout call ``index`` under ``key``."""
    return int(np.random.SeedSequence([*key, index]).generate_state(
        1, np.uint64)[0])


def _mulhilo(a: int, b: torch.Tensor):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    low = (p_lo & _MASK) + ((p_hi & 0xFFFF) << 16)
    return (p_lo >> 32) + (p_hi >> 16) + (low >> 32), low & _MASK


def philox(c0, c1, c2, c3, seed: int):
    """Philox-4x32-10 of uint32 counters held in int64 tensors."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(seed: int, streams: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) int64: the words of positions 0 .. n-1 of each stream."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64,
                          device=streams.device)
    c1 = streams.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=streams.device)
    w = philox(groups[None, :], c1, zero, zero, seed)
    return torch.stack([x.expand(c1.shape[0], -1) for x in w],
                       dim=-1).reshape(c1.shape[0], -1)[:, :n]


def site_bytes(seed: int, layer: int, site: int, rows: torch.Tensor,
               positions: int, width: int) -> torch.Tensor:
    """(len(rows), positions, width) uint8 bytes of one site for the
    given batch rows."""
    w = words(seed, layer * LAYER_STRIDE + rows, positions * width)
    return ((w >> (8 * site)) & 255).to(torch.uint8).reshape(
        rows.shape[0], positions, width)


def apply(x: torch.Tensor, bytes_: torch.Tensor, rate: float) -> torch.Tensor:
    """u8-threshold dropout of ``x`` by ``bytes_`` (x's shape)."""
    thresh = int(round(rate * 256))
    if thresh <= 0:
        return x
    keep = 1.0 - thresh / 256.0
    return torch.where(bytes_ >= thresh, x / keep, torch.zeros_like(x))


class StepDropout:
    """The dropout of one training step over the batch rows ``rows``: the
    seeds are handed out in the order the program's forward makes its
    dropout calls."""

    def __init__(self, key: Sequence[int], rate: float,
                 rows: torch.Tensor) -> None:
        self.key = tuple(key)
        self.rate = rate
        self.rows = rows
        self.calls = 0

    def _next(self) -> int:
        s = call_seed(self.key, self.calls)
        self.calls += 1
        return s

    def composed(self, x: torch.Tensor) -> torch.Tensor:
        """A composed site: x is (rows, ..., width)."""
        seed = self._next()
        lead, width = x.shape[0], x.shape[-1]
        b = site_bytes(seed, 0, 0, self.rows, x.numel() // (lead * width),
                       width).reshape(x.shape)
        return apply(x, b, self.rate)

    def stack(self) -> "StackDropout":
        return StackDropout(self._next(), self.rate, self.rows)


class StackDropout:
    """One fused stack's sites: site k of layer l, x (rows, T, d)."""

    def __init__(self, seed: int, rate: float, rows: torch.Tensor) -> None:
        self.seed = seed
        self.rate = rate
        self.rows = rows
        self._words = {}

    def site(self, x: torch.Tensor, layer: int, k: int) -> torch.Tensor:
        _, T, d = x.shape
        w = self._words.get(layer)
        if w is None:
            w = words(self.seed, layer * LAYER_STRIDE + self.rows, T * d)
            self._words = {layer: w}
        b = ((w >> (8 * k)) & 255).to(torch.uint8).reshape(x.shape)
        return apply(x, b, self.rate)
