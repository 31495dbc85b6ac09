"""What the per-layer metrics of the program's own spans share: interval
arithmetic on a traced sub-window (``devtrace.Trace``).

The program names its phases with host ranges ``sk.*`` that PyTorch's
profiler records beside the device's operations, on the same clock. An
interval is a (start, end) pair in the trace's microseconds:

- *idle* is the traced window [w0, w1] less the device's busy spans
  (``trace.busy``, sorted, disjoint and clipped to the window);
- *U(S)* is the union of the main thread's host events whose names are in
  S (``trace.host``), clipped to the window by the trace's own merge, so
  overlapping or nested spans count once.

Every function returns None where the trace is None or holds none of the
spans it reads, as a trace of a program without them does.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def length(spans: Sequence[Interval]) -> float:
    return sum(t - s for s, t in spans)


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> List[Interval]:
    """The traced window less the device's busy spans."""
    out, at = [], trace.w0
    for s, t in trace.busy:
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if at < trace.w1:
        out.append((at, trace.w1))
    return out


def named(trace, names: Sequence[str]) -> Optional[List[Interval]]:
    """U(names), or None where the trace holds none of the spans."""
    spans = [(s, t) for n, s, t in trace.host if n in names]
    if not spans:
        return None
    return trace._merged(spans)


def ms_per_unit(trace, names: Sequence[str]) -> Optional[float]:
    """|U(names)| a traced unit, in ms."""
    u = None if trace is None else named(trace, names)
    if u is None:
        return None
    return length(u) / 1e3 / trace.units


def idle_ms_per_unit(trace, names: Sequence[str]) -> Optional[float]:
    """|idle and U(names)| a traced unit, in ms: the device's idle time
    while the host was inside those spans."""
    u = None if trace is None else named(trace, names)
    if u is None:
        return None
    return overlap(idle(trace), u) / 1e3 / trace.units


def turnaround_ms(trace, root: str,
                  kernels: Sequence[str]) -> Optional[float]:
    """The median, over consecutive pairs of the kernels whose name holds
    a pattern of ``kernels`` that start inside the same ``root`` span, of
    the later's start less the earlier's end, in ms."""
    if trace is None:
        return None
    gaps: List[float] = []
    for n, rs, rt in trace.host:
        if n != root:
            continue
        ks = sorted((s, t) for k, s, t in trace.kernels
                    if rs <= s <= rt and any(p in k for p in kernels))
        gaps += [b[0] - a[1] for a, b in zip(ks, ks[1:])]
    if not gaps:
        return None
    return statistics.median(gaps) / 1e3
