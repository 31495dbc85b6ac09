"""Metric computation + logging: scalar series, reconstruction grids,
notifier fan-out.

Capability parity with the reference's metric framework (reference:
core/metrics.py — registered metric classes computed on validation slices,
scalars + plot images pushed to TensorBoard and the notifier). Re-design:

- ``MetricWriter`` appends scalars to JSONL and saves images as ``.npy``;
- plot metrics use the pure-numpy rasterizer (utils has no matplotlib
  dependency on the step path);
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, Iterable, Optional

import numpy as np

from sketchformer_tpu_torch.data import stroke3


class MetricWriter:
    """Scalars -> ``metrics.jsonl`` per step; images -> ``images/*.npy``."""

    def __init__(self, run_dir: str) -> None:
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def write_image(self, step: int, name: str, image: np.ndarray) -> None:
        """image (H, W) or (H, W, C) float in [0,1]; saved as npy."""
        img_dir = os.path.join(self.run_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        np.save(os.path.join(img_dir, f"{name}_{step:08d}.npy"), image)

    def close(self) -> None:
        self._jsonl.close()


class NullMetricWriter:
    """No-op writer for non-primary processes in multi-process runs: the
    run dir has ONE writer (rank 0), everyone else burns no IO."""

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        pass

    def write_image(self, step: int, name: str, image: np.ndarray) -> None:
        pass

    def close(self) -> None:
        pass


def reconstruction_grid(
    originals: Iterable[np.ndarray],
    reconstructions: Iterable[np.ndarray],
    side: int = 64,
    max_pairs: int = 8,
) -> np.ndarray:
    """2-row image grid: originals on top, reconstructions below.

    (Reference pushes matplotlib grids to TensorBoard/Slack; this is the
    numpy equivalent, renderable anywhere.)
    """
    pairs = list(zip(originals, reconstructions))[:max_pairs]
    if not pairs:
        return np.zeros((2 * side, side), np.float32)
    top = [stroke3.rasterize(o, side) for o, _ in pairs]
    bot = [
        stroke3.rasterize(r, side) if len(r) else np.zeros((side, side))
        for _, r in pairs
    ]
    return np.concatenate(
        [np.concatenate(top, axis=1), np.concatenate(bot, axis=1)], axis=0
    ).astype(np.float32)


def sketch_strip(
    sketches: Iterable[np.ndarray], side: int = 64, max_n: int = 16
) -> np.ndarray:
    """1-row image strip of sketches (e.g. a latent interpolation path)."""
    cells = [
        stroke3.rasterize(s, side) if len(s) else np.zeros((side, side))
        for s in list(sketches)[:max_n]
    ]
    if not cells:
        return np.zeros((side, side), np.float32)
    return np.concatenate(cells, axis=1).astype(np.float32)


@contextlib.contextmanager
def profile_block(run_dir: Optional[str] = None, enabled: bool = False):
    """``torch.profiler`` trace around a code block (host activity, and the
    card's kernels where CUDA is available), written as a Chrome trace to
    ``run_dir/profile/<host>_<pid>.pt.trace.json`` (Perfetto,
    chrome://tracing)."""
    if not enabled or run_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir = os.path.join(run_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json"))


class StepTimer:
    """Rolling steps/sec + examples/sec on the host-visible step boundary."""

    def __init__(self, window: int = 50) -> None:
        self.window = window
        self._times = []  # (t, n_steps_at_t)
        self._n = 0

    def tick(self, n_steps: int = 1) -> None:
        """One device dispatch completed, advancing ``n_steps`` optimizer
        steps (steps_per_call > 1 dispatches advance several)."""
        self._n += n_steps
        self._times.append((time.perf_counter(), self._n))
        if len(self._times) > self.window + 1:
            self._times.pop(0)

    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        (t0, n0), (t1, n1) = self._times[0], self._times[-1]
        return (n1 - n0) / max(t1 - t0, 1e-9)
