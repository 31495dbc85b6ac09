"""u8-threshold dropout.

Port of ``sketchformer_tpu/models/dropout.py``: an element drops when its
random byte is < round(rate * 256), so the keep probability is quantised to
1/256 steps, and kept values are divided by the REALISED keep rate
1 - thresh / 256, which keeps E[dropout(x)] == x exactly (at rate 0.1 the
keep rate is 0.8984). The JAX module's ``impl='exact'`` Bernoulli variant,
which no configuration uses, is not ported.

Where the bytes come from:

- on the CPU, from an explicit ``torch.Generator``: the one set with
  :func:`use_generator` around a forward pass (the train step sets one per
  step, derived from the run seed and the step), else PyTorch's default
  generator;
- on the card, from the Philox stream of ``ops/dropout_prng.py`` (K7), as
  the fused stacks draw theirs: each dropout call (a composed site, or a
  whole fused stack) takes the next seed of :func:`next_seed`, derived on
  the host from the context's seed key (run seed, step, microbatch) and the
  call's index, so no device value is read back to draw it. A composed site
  emits its bytes with ``emit_dropout_bits`` (one layer, one site).

``bits`` lets a caller (a test) hand in the bytes, for example the JAX
package's draw. The sites are active only in a module's training mode;
every serving path runs the model in eval mode.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sketchformer_tpu_torch.ops.dropout_prng import emit_dropout_bits

_state = threading.local()


@contextlib.contextmanager
def use_generator(generator: Optional[torch.Generator],
                  seed_key: Optional[Sequence[int]] = None
                  ) -> Iterator[None]:
    """Draw every dropout site's bytes from ``generator`` inside the block
    (on the CPU), and key the card's Philox draws with ``seed_key``."""
    prev = (current_generator(), getattr(_state, "seed_key", None),
            getattr(_state, "calls", 0))
    _state.generator = generator
    _state.seed_key = None if seed_key is None else tuple(seed_key)
    _state.calls = 0
    try:
        yield
    finally:
        _state.generator, _state.seed_key, _state.calls = prev


def current_generator() -> Optional[torch.Generator]:
    return getattr(_state, "generator", None)


def next_seed() -> int:
    """The 64-bit Philox seed of the next dropout call: from the context's
    seed key and the call's index inside it (host arithmetic only), or a
    draw of PyTorch's CPU generator outside any keyed context."""
    key = getattr(_state, "seed_key", None)
    if key is None:
        return int(torch.randint(0, 2 ** 62, (1,)).item())
    n = _state.calls
    _state.calls = n + 1
    return int(np.random.SeedSequence([*key, n]).generate_state(
        1, np.uint64)[0])


def dropout(x: torch.Tensor, rate: float, *, training: bool = True,
            bits: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Functional dropout with the JAX package's semantics; ``bits`` (u8,
    x's shape) replaces the draw."""
    thresh = int(round(rate * 256))
    if not training or thresh <= 0:
        return x
    if bits is None and x.device.type == "cuda" and generator is None:
        lead = x.shape[0] if x.dim() > 1 else 1
        d = x.shape[-1]
        bits = emit_dropout_bits(next_seed(), 1, 1, lead,
                                 x.numel() // max(lead * d, 1), d,
                                 x.device).reshape(x.shape)
    elif bits is None:
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
