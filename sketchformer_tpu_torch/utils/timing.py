"""Timing on the card: device time of a call, its spread beside a plain
version and a library call, a kernel's own events in a profiler trace, the
least time the card could take for a call's work, and the card's identity.

``chip_smoke.py`` times its kernels with these. Nothing here imports
the rest of the package, so a script can load this module beside another
checkout's package. Every function that touches the card imports torch
inside.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np

# per-call timings of a kernel's spread: calls of each side
SPREAD_CALLS = 60
# cycles the card spins before each timed call, long enough for the host to
# queue the call's launches (a few ms at the H100's clock): the events then
# time the device's work alone, not the host's launch overhead
QUEUE_AHEAD_CYCLES = 4_000_000


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def call_ms(fn, n, warm=5):
    """Device time (ms) of each of ``n`` calls after ``warm`` calls: each
    call between its own CUDA events, queued behind a spin of the card so
    that the host's launch overhead is not in it."""
    import torch

    for _ in range(warm):
        fn()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def spread_ms(kernel_fn, plain_fn, lib_fn, n=SPREAD_CALLS):
    """(median, min, max) device ms (``call_ms``) of the kernel, the plain
    version and the library call (or None): n calls each, in turns plain,
    kernel, library, kernel, plain, library (n / 2 a turn)."""
    out = {"kernel": [], "plain": [], "lib": []}
    for name, fn in (("plain", plain_fn), ("kernel", kernel_fn),
                     ("lib", lib_fn), ("kernel", kernel_fn),
                     ("plain", plain_fn), ("lib", lib_fn)):
        if fn is not None:
            out[name] += call_ms(fn, n // 2)
    return {k: (float(np.median(v)), min(v), max(v)) if v else None
            for k, v in out.items()}


# a kernel trace's guard: seconds the host idles inside the profiler's
# window before the first launch and after the last; and the least share
# of a trace's launches whose device events it must keep. As the process
# ages, the window drops device events: a probe that traced 60 of
# PyTorch's own small bf16 products every 20 s beside a busy card (NVIDIA
# H100 80GB HBM3, 700 W) lost none in the first 20 s, then one more of the
# 60 every 10 s or so without the guard, and none from about 150 s on with
# it. So a kernel's time is the median of the events its trace kept
TRACE_GUARD_S = 0.25
TRACE_KEPT_SHARE = 0.5


class TraceTooShort(RuntimeError):
    """A kernel trace kept fewer of a kernel's events than it must."""


@contextlib.contextmanager
def device_trace():
    """A torch.profiler session of host and device activity whose calls
    run TRACE_GUARD_S seconds inside each end of its window; the card is
    synchronised before the window closes."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(TRACE_GUARD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_GUARD_S)


def kernel_spread(fn, names, n=SPREAD_CALLS):
    """{name: (median, min, max, events kept)} device ms of each kernel
    whose name holds one of ``names``, from its events in a
    ``device_trace`` of ``n`` calls of ``fn`` (after one warm call), each
    call launching each named kernel once: a trace keeps at most ``n`` of
    a name's events, and must keep TRACE_KEPT_SHARE of them (else
    :class:`TraceTooShort`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with device_trace() as prof:
        for _ in range(n):
            fn()
    got = {k: [] for k in names}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        for k in names:
            if k in e.name:
                got[k].append(e.time_range.elapsed_us() / 1e3)
    for k, v in got.items():
        if not n * TRACE_KEPT_SHARE <= len(v) <= n:
            raise TraceTooShort(f"profiler: {len(v)} {k} events in {n} calls")
    return {k: (float(np.median(v)), min(v), max(v), len(v))
            for k, v in got.items()}


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work
# ---------------------------------------------------------------------------

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core rate, FLOP/s
PEAK_F32 = 67e12        # float32 outside the tensor cores
HBM = 3.35e12           # bytes/s


def bound(flops, nbytes, dtype_bytes=2):
    """(ms, 'operations' | 'bytes'): the larger of the two times; the
    operations at the bf16 tensor-core peak (``dtype_bytes`` 2) or the f32
    peak outside the tensor cores (4)."""
    peak = PEAK_BF16 if dtype_bytes == 2 else PEAK_F32
    t_op, t_by = flops / peak, nbytes / HBM
    return (max(t_op, t_by) * 1e3,
            "operations" if t_op >= t_by else "bytes")
