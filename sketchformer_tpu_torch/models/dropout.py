"""u8-threshold dropout.

Port of ``sketchformer_tpu/models/dropout.py``: an element drops when its
random byte is < round(rate * 256), so the keep probability is quantised to
1/256 steps, and kept values are divided by the REALISED keep rate
1 - thresh / 256, which keeps E[dropout(x)] == x exactly (at rate 0.1 the
keep rate is 0.8984). The JAX module's ``impl='exact'`` Bernoulli variant,
which no configuration uses, is not ported.

Bytes come from an explicit ``torch.Generator``: the one set with
:func:`use_generator` around a forward pass (the train step sets one per
step, derived from the run seed and the step), else PyTorch's default
generator of the device. ``bits`` lets a caller (a test) hand in the bytes,
for example the JAX package's draw. The sites are active only in a module's
training mode; every serving path runs the model in eval mode.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch
from torch import nn

_state = threading.local()


@contextlib.contextmanager
def use_generator(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Draw every dropout site's bytes from ``generator`` inside the block."""
    prev = getattr(_state, "generator", None)
    _state.generator = generator
    try:
        yield
    finally:
        _state.generator = prev


def current_generator() -> Optional[torch.Generator]:
    return getattr(_state, "generator", None)


def dropout(x: torch.Tensor, rate: float, *, training: bool = True,
            bits: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Functional dropout with the JAX package's semantics; ``bits`` (u8,
    x's shape) replaces the draw."""
    thresh = int(round(rate * 256))
    if not training or thresh <= 0:
        return x
    if bits is None:
        gen = generator if generator is not None else current_generator()
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             generator=gen, device=x.device)
    keep_rate = 1.0 - thresh / 256.0
    return torch.where(bits >= thresh, x / keep_rate, 0).to(x.dtype)


class Dropout(nn.Module):
    """A dropout site: active in training mode, the identity in eval."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, training=self.training)
