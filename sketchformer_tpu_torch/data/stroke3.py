"""Stroke-3 geometry: normalization, conversions, RDP simplification.

Capability parity with the reference's sketch utilities (reference:
utils/sketch.py — stroke3<->polyline conversion, offset-scale normalization
by the dataset sigma, RDP-simplified QuickDraw handling, rasterization for
metric plots).

Representation. A sketch is an ``(N, 3)`` float array of rows
``(dx, dy, pen_lift)`` where ``pen_lift`` is 1 when the pen is lifted AFTER
this point (end of a stroke), else 0. This is Google QuickDraw / sketch-rnn
"stroke-3" format.

Design notes (TPU-first):
- All per-batch transforms used on the training step path (normalize, delta
  encode, pad) are pure numpy/jnp-vectorizable with static shapes; RDP is
  inherently recursive so it stays an OFFLINE host-side prep function (the
  QuickDraw release ships pre-simplified data, matching the reference's
  effective behavior).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def strokes_to_lines(strokes: np.ndarray) -> List[np.ndarray]:
    """Convert stroke-3 deltas to a list of absolute-coordinate polylines."""
    coords = np.cumsum(strokes[:, :2], axis=0)
    pen_lift = strokes[:, 2]
    lines: List[np.ndarray] = []
    start = 0
    for i in range(len(strokes)):
        if pen_lift[i] >= 0.5:
            lines.append(coords[start : i + 1].copy())
            start = i + 1
    if start < len(strokes):
        lines.append(coords[start:].copy())
    return lines


def lines_to_strokes(lines: Sequence[np.ndarray]) -> np.ndarray:
    """Convert absolute-coordinate polylines to stroke-3 deltas.

    The first point's delta is taken from the origin (0, 0).
    """
    pts = []
    pen = []
    for line in lines:
        line = np.asarray(line, dtype=np.float32)
        if line.ndim != 2 or line.shape[1] != 2 or len(line) == 0:
            raise ValueError("each line must be a non-empty (K, 2) array")
        pts.append(line)
        p = np.zeros(len(line), dtype=np.float32)
        p[-1] = 1.0
        pen.append(p)
    coords = np.concatenate(pts, axis=0)
    pen_lift = np.concatenate(pen, axis=0)
    deltas = np.diff(np.concatenate([np.zeros((1, 2), np.float32), coords]), axis=0)
    return np.concatenate([deltas, pen_lift[:, None]], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def compute_deviation(sketches: Sequence[np.ndarray]) -> float:
    """Std-dev of all (dx, dy) deltas across a dataset (QuickDraw sigma).

    Matches the sketch-rnn convention the reference uses: a single scalar
    scale computed over the concatenated delta components.
    """
    all_deltas = np.concatenate([s[:, :2].reshape(-1) for s in sketches])
    return float(np.std(all_deltas))


def normalize(strokes: np.ndarray, scale: float) -> np.ndarray:
    out = strokes.astype(np.float32).copy()
    out[:, :2] /= scale
    return out


def denormalize(strokes: np.ndarray, scale: float) -> np.ndarray:
    out = strokes.astype(np.float32).copy()
    out[:, :2] *= scale
    return out


# ---------------------------------------------------------------------------
# RDP simplification (offline / host-side only)
# ---------------------------------------------------------------------------


def _rdp_mask(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Iterative Ramer-Douglas-Peucker keep-mask over an (N, 2) polyline."""
    n = len(points)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[n - 1] = True
    stack: List[Tuple[int, int]] = [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi <= lo + 1:
            continue
        seg = points[hi] - points[lo]
        seg_len = np.hypot(seg[0], seg[1])
        rel = points[lo + 1 : hi] - points[lo]
        if seg_len < 1e-12:
            dists = np.hypot(rel[:, 0], rel[:, 1])
        else:
            dists = np.abs(rel[:, 0] * seg[1] - rel[:, 1] * seg[0]) / seg_len
        imax = int(np.argmax(dists))
        if dists[imax] > epsilon:
            split = lo + 1 + imax
            keep[split] = True
            stack.append((lo, split))
            stack.append((split, hi))
    return keep


def rdp_simplify(strokes: np.ndarray, epsilon: float = 2.0) -> np.ndarray:
    """RDP-simplify each stroke of a stroke-3 sketch (host-side, offline).

    QuickDraw's sketch-rnn release is already RDP(eps=2.0)-simplified; this
    exists for raw-input pipelines and prep scripts.
    """
    lines = strokes_to_lines(strokes)
    simplified = []
    for line in lines:
        if len(line) <= 2:
            simplified.append(line)
        else:
            simplified.append(line[_rdp_mask(line, epsilon)])
    return lines_to_strokes(simplified)


# ---------------------------------------------------------------------------
# padding / batch assembly (host-side; shapes static per bucket)
# ---------------------------------------------------------------------------


def pad_batch(
    sketches: Sequence[np.ndarray], max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of stroke-3 sketches to ``(B, max_len, 3)``.

    Returns ``(padded, lengths)``. Sketches longer than ``max_len`` are
    truncated. Padding rows are all-zero (and masked downstream via lengths).
    """
    batch = np.zeros((len(sketches), max_len, 3), dtype=np.float32)
    lengths = np.zeros(len(sketches), dtype=np.int32)
    for i, s in enumerate(sketches):
        n = min(len(s), max_len)
        batch[i, :n] = s[:n]
        lengths[i] = n
    return batch, lengths


# ---------------------------------------------------------------------------
# rasterization (host-side, for metric plots)
# ---------------------------------------------------------------------------


def rasterize(strokes: np.ndarray, side: int = 64, pad_frac: float = 0.05) -> np.ndarray:
    """Render a stroke-3 sketch to a ``(side, side)`` float32 image in [0, 1].

    Pure-numpy Bresenham-style line drawing — no matplotlib on the metric
    path, so it is cheap enough to run per validation step.
    """
    img = np.zeros((side, side), dtype=np.float32)
    lines = strokes_to_lines(strokes)
    if not lines:
        return img
    all_pts = np.concatenate(lines, axis=0)
    lo = all_pts.min(axis=0)
    hi = all_pts.max(axis=0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    pad = pad_frac * side
    scale = (side - 1 - 2 * pad) / span

    def to_px(p: np.ndarray) -> Tuple[int, int]:
        x = int(round(pad + (p[0] - lo[0]) * scale))
        y = int(round(pad + (p[1] - lo[1]) * scale))
        return min(max(x, 0), side - 1), min(max(y, 0), side - 1)

    for line in lines:
        for a, b in zip(line[:-1], line[1:]):
            x0, y0 = to_px(a)
            x1, y1 = to_px(b)
            n = max(abs(x1 - x0), abs(y1 - y0), 1)
            xs = np.linspace(x0, x1, n + 1).round().astype(int)
            ys = np.linspace(y0, y1, n + 1).round().astype(int)
            img[ys, xs] = 1.0
        if len(line) == 1:
            x0, y0 = to_px(line[0])
            img[y0, x0] = 1.0
    return img
