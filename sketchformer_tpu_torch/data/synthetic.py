"""Synthetic QuickDraw-like sketch generator.

The environment has no network access, so real QuickDraw npz releases may be
absent. This generator produces plausible RDP-like stroke-3 sketches with
class-dependent structure (so classifiers have signal to learn) and is used
by tests, the synthetic dataloader, and the benchmark harness. Every later
pipeline stage is exercised end-to-end against it.

Classes are parameterized shape families (polygons, stars, spirals, waves)
whose parameters vary smoothly with the class id — a 345-class synthetic
gallery is therefore meaningful for classification/SBIR smoke evaluation.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sketchformer_tpu_torch.data import stroke3


def _polygon(rng: np.random.Generator, sides: int, jitter: float) -> List[np.ndarray]:
    angles = np.linspace(0, 2 * np.pi, sides + 1) + rng.uniform(0, 2 * np.pi)
    radii = 1.0 + jitter * rng.standard_normal(sides + 1)
    radii[-1] = radii[0]
    pts = np.stack([radii * np.cos(angles), radii * np.sin(angles)], axis=1)
    return [pts.astype(np.float32)]


def _star(rng: np.random.Generator, points: int, jitter: float) -> List[np.ndarray]:
    n = 2 * points
    angles = np.linspace(0, 2 * np.pi, n + 1) + rng.uniform(0, 2 * np.pi)
    radii = np.where(np.arange(n + 1) % 2 == 0, 1.0, 0.45)
    radii = radii * (1.0 + jitter * rng.standard_normal(n + 1))
    radii[-1] = radii[0]
    pts = np.stack([radii * np.cos(angles), radii * np.sin(angles)], axis=1)
    return [pts.astype(np.float32)]


def _spiral(rng: np.random.Generator, turns: float, jitter: float) -> List[np.ndarray]:
    n = int(12 * turns) + 4
    t = np.linspace(0, turns * 2 * np.pi, n)
    r = np.linspace(0.1, 1.0, n) * (1.0 + jitter * rng.standard_normal(n))
    pts = np.stack([r * np.cos(t), r * np.sin(t)], axis=1)
    return [pts.astype(np.float32)]


def _waves(rng: np.random.Generator, humps: int, jitter: float) -> List[np.ndarray]:
    lines = []
    for row in range(2):
        n = 4 * humps + 1
        x = np.linspace(-1, 1, n)
        y = 0.4 * np.sin(humps * np.pi * x) + 0.5 * row
        y = y + jitter * rng.standard_normal(n) * 0.1
        lines.append(np.stack([x, y], axis=1).astype(np.float32))
    return lines


_FAMILIES = (_polygon, _star, _spiral, _waves)


def _class_structure(class_id: int) -> dict:
    """Deterministic per-class structural parameters.

    Every class id gets a DISTINCT structure (family + size + aspect + shear
    + rotation + marker glyph), so a 345-class synthetic dataset is actually
    345-way separable — family/size alone would alias classes mod 36 and cap
    val accuracy near 10%.
    """
    srng = np.random.default_rng(class_id * 7919 + 13)
    return dict(
        family=int(srng.integers(len(_FAMILIES))),
        size=3 + int(srng.integers(9)),
        aspect=0.5 + 1.0 * float(srng.random()),
        shear=0.8 * float(srng.random()) - 0.4,
        rotation=2 * np.pi * float(srng.random()),
        marker_sides=3 + int(srng.integers(4)),
        marker_angle=2 * np.pi * float(srng.random()),
        marker_radius=1.5 + 0.8 * float(srng.random()),
        marker_scale=0.25 + 0.2 * float(srng.random()),
    )


def generate_sketch(
    class_id: int, rng: np.random.Generator, jitter: float = 0.06
) -> np.ndarray:
    """One stroke-3 sketch for ``class_id``; structure depends on the id."""
    s = _class_structure(class_id)
    fam = _FAMILIES[s["family"]]
    if fam is _spiral:
        lines = fam(rng, 1.0 + 0.35 * s["size"], jitter)
    else:
        lines = fam(rng, s["size"], jitter)
    # class-identifying marker glyph outside the main shape
    m_ang = s["marker_angle"] + 0.05 * rng.standard_normal()
    center = s["marker_radius"] * np.asarray(
        [np.cos(m_ang), np.sin(m_ang)], dtype=np.float32)
    marker = _polygon(rng, s["marker_sides"], jitter)[0] * s["marker_scale"] + center
    lines = lines + [marker.astype(np.float32)]
    # class-deterministic affine (aspect, shear, rotation) + instance noise
    rot = s["rotation"] + 0.08 * rng.standard_normal()
    c, sn = np.cos(rot), np.sin(rot)
    affine = np.asarray(
        [[c, -sn], [sn, c]], np.float32) @ np.asarray(
        [[s["aspect"], s["shear"]], [0.0, 1.0]], np.float32)
    scale = rng.uniform(20.0, 60.0)
    lines = [(l @ affine.T) * scale for l in lines]
    return stroke3.lines_to_strokes(lines)


def generate_dataset(
    num_classes: int,
    per_class: int,
    seed: int = 0,
    jitter: float = 0.06,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Returns ``(sketches, labels)`` shuffled across classes."""
    rng = np.random.default_rng(seed)
    sketches: List[np.ndarray] = []
    labels: List[int] = []
    for c in range(num_classes):
        for _ in range(per_class):
            sketches.append(generate_sketch(c, rng, jitter))
            labels.append(c)
    perm = rng.permutation(len(sketches))
    return [sketches[i] for i in perm], np.asarray(labels)[perm].astype(np.int32)
