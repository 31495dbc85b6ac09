"""Engine-selection observability: warn ONCE when a fast path is declined.

Round-2 verdict ("silent engine fallback"): `make_token_decoder`, the
fused-stack gates, and `fast_embed` all selected fused-vs-composed
silently — a user running an unsupported config got the slow path with no
log line, the perf flavor of a silent cap. Every selection site now calls
:func:`note_engine`; the first decline per (site, engine, reason) logs a
warning, repeat calls are free (selection runs inside jit tracing, so the
dedup also keeps retraces quiet).

The port keeps its own copy (and its own once-per-process record) under
the logger ``sketchformer_tpu_torch.engines``. Under a profiler every call
also records the mark ``engine.<site>.<engine>`` (``utils/trace.py``), so
a trace counts each selection, silent fallbacks included.
"""

from __future__ import annotations

import logging
from typing import Set, Tuple

from sketchformer_tpu_torch.utils.trace import mark

log = logging.getLogger("sketchformer_tpu_torch.engines")

_seen: Set[Tuple[str, str, str]] = set()


def note_engine(site: str, engine: str, reason: str = "") -> None:
    """Record the engine chosen at ``site``; log once per distinct event.

    ``engine`` is the path taken (e.g. ``"composed"``, ``"fused"``);
    ``reason`` says why a faster path was declined (empty for the fast
    path itself, which logs at INFO).
    """
    mark("engine", site, engine)
    key = (site, engine, reason)
    if key in _seen:
        return
    _seen.add(key)
    if reason:
        log.warning("%s: using %s path — %s", site, engine, reason)
    else:
        log.info("%s: using %s path", site, engine)


def reset_seen() -> None:
    """Clear the once-per-process dedup (tests)."""
    _seen.clear()
