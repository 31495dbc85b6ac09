"""The device trace of a traced run: a guarded ``torch.profiler`` sub-window
of a fixed number of units (batches, requests or steps), and what the
per-layer metrics read from it.

The sub-window opens with the card drained (a synchronise), idles the
host ``GUARD_S`` inside each end of the profiler's window (late in a
process a window drops the device events nearest its start; the guard
keeps the traced units clear of its ends), and marks the traced units with
a ``record_function`` range whose host span is the traced window. A trace
whose device kept fewer kernel events than the host launched lost events:
it is refused, and the run traces a second sub-window.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

MARK = "perfbench.traced"
GUARD_S = 0.25
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
COPIES = ("Memcpy", "Memset")
# host events in which the host waits on the device: a read of a device
# value (``.item()``, ``float()``, ``bool()``) and the synchronises
WAITS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
         "cudaDeviceSynchronize", "cudaEventSynchronize")
TOP = 10


def _on_card() -> bool:
    return torch.cuda.is_available()


def _sync() -> None:
    if _on_card():
        torch.cuda.synchronize()


class SubWindow:
    """Opens and closes one profiled sub-window around the units the
    driver runs between :meth:`start` and :meth:`stop`."""

    def __init__(self) -> None:
        self.prof = None
        self.mark = None

    def start(self) -> None:
        _sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if _on_card():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        time.sleep(GUARD_S)
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        _sync()
        self.mark.__exit__(None, None, None)
        time.sleep(GUARD_S)
        self.prof.__exit__(None, None, None)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters; copies keep theirs."""
    if name.startswith(COPIES):
        return name
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name.strip()


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


class Trace:
    """What one sub-window recorded: its host span (``window_s``), the
    device's operations in it, the host's kernel launches, the main
    thread's host events and the spans in which the host waited on the
    device."""

    def __init__(self, prof, units: int) -> None:
        events = list(prof.events())
        marks = [e for e in events if e.name == MARK and not _is_device(e)]
        if not marks:
            raise RuntimeError("trace: the traced range was not recorded")
        mark = marks[0]
        self.units = units
        self.w0 = mark.time_range.start
        self.w1 = mark.time_range.end
        self.window_s = (self.w1 - self.w0) / 1e6
        thread = getattr(mark, "thread", None)
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.waits: List[Tuple[float, float]] = []
        self.launches = 0
        for e in events:
            if e.name.startswith("perfbench."):
                continue
            s, t = e.time_range.start, e.time_range.end
            if _is_device(e):
                if getattr(e, "is_user_annotation", False):
                    continue
                self.device.append((e.name, s, t))
            elif self.w0 <= s <= self.w1:
                if e.name.startswith(LAUNCHES):
                    self.launches += 1
                if e.name in WAITS:
                    self.waits.append((s, t))
                if thread is None or getattr(e, "thread", None) == thread:
                    self.host.append((e.name, s, t))
        self.kernels = [x for x in self.device if not x[0].startswith(COPIES)]
        self.busy = self._merged()
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6

    @property
    def lost(self) -> bool:
        """Whether the device kept fewer kernel events than the host
        launched (unknown, so False, when no launch was recorded)."""
        return 0 < self.launches and len(self.kernels) < self.launches

    def _merged(self, spans=None) -> List[Tuple[float, float]]:
        """The union of ``spans`` (the device's operations by default),
        clipped to the traced window, as sorted disjoint spans."""
        if spans is None:
            spans = [(s, t) for _, s, t in self.device]
        spans = sorted((max(s, self.w0), min(t, self.w1)) for s, t in spans)
        out: List[Tuple[float, float]] = []
        for s, t in spans:
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], t))
            else:
                out.append((s, t))
        return out

    # --- what the metrics read -----------------------------------------------

    def kernel_seconds(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds a pattern."""
        return sum(t - s for n, s, t in self.kernels
                   if any(p in n for p in patterns)) / 1e6

    def kernel_count(self) -> int:
        return len(self.kernels)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def waiting_s(self) -> float:
        """Seconds of the traced window in which the host waited on the
        device (the union of its ``WAITS`` events)."""
        return sum(t - s for s, t in self._merged(self.waits)) / 1e6

    # --- the breakdown -------------------------------------------------------

    def device_ops(self) -> List[List]:
        totals: Dict[str, float] = {}
        for n, s, t in self.device:
            k = short_name(n)
            totals[k] = totals.get(k, 0.0) + (t - s) / 1e6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k, v] for k, v in top]

    def idle_gaps(self) -> List[List]:
        """The longest spans of the traced window in which the device ran
        nothing, each named by the innermost host event of the main
        thread that covers its middle."""
        gaps, at = [], self.w0
        for s, t in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if at < self.w1:
            gaps.append((at, self.w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, t in gaps[:TOP]:
            mid = (s + t) / 2
            cover = [(hs, n) for n, hs, ht in self.host if hs <= mid <= ht]
            name = max(cover)[1] if cover else "host outside any event"
            out.append([name, (t - s) / 1e6])
        return out
