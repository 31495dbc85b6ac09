"""Named spans of the program's phases, recorded into PyTorch's profiler.

``span(name)`` marks a phase of the program (an embed batch, a decode
request and its chunks, a training step and its parts) as the range
``"sk." + name``. The range is recorded only while a ``torch.profiler``
session records, through ``torch.profiler.record_function``: it then lands
in the profiler's timeline beside the device's kernels and copies, on the
same clock, and the profiler owns its export (a Chrome trace, or
``prof.events()``). With no session recording, ``span`` returns one shared
null context, so a phase costs a check of PyTorch's own flag.

A span never reads a device value, never synchronises and never changes
which kernels run. Spans nest on the calling thread: a unit's phases lie
inside its root span (``embed.batch``, ``decode.request``,
``train.step``). ``mark(*parts)`` records a zero-length span, a count.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "sk."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over the phase ``name``: the profiler range
    ``"sk." + name`` while a session records, else a shared null
    context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def mark(*parts: str) -> None:
    """Record that the event named by ``parts`` (joined by dots) happened,
    as a zero-length span, while a session records; its count in a trace
    is the number of times. The name is built only then."""
    if _profiler._is_profiler_enabled:
        with torch.profiler.record_function(PREFIX + ".".join(parts)):
            pass
