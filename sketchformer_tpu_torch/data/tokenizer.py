"""Sketch tokenizers: spatial-grid quantization and learned-codebook.

Capability parity with the reference's tokenizers (reference:
utils/tokenizer.py — ``Tokenizer`` with a k-means codebook over (dx, dy)
deltas fitted offline in prep_data/, and ``GridTokenizer`` quantizing onto an
R x R spatial grid; both with specials PAD/SOS/EOS/SEP and
``encode(stroke3) -> ids`` / ``decode(ids) -> stroke3``).

TPU-first notes:
- Both encoders' per-point cores are pure vectorized array math (floor-divide
  for the grid; an argmin-over-centroids — one (N, K) matmul, MXU-friendly —
  for the codebook). SEP insertion makes token sequences variable-length and
  happens host-side at batch-assembly time; the device path sees only padded
  int32 token tensors with static bucket shapes.
- The codebook fit is a tiny numpy k-means (no sklearn dependency), run
  offline in data prep exactly like the reference; fitted centroids round-trip
  via npz so a reference dictionary can be dropped in for fidelity checks.

Token layout (both tokenizers)::

    PAD = 0, SOS = 1, EOS = 2, SEP = 3, content tokens in [4, 4 + V)

A sketch encodes as ``[content(p_1), .., content(p_i), SEP (if pen lift), ..]``
without SOS/EOS; the pipeline adds SOS/EOS when building decoder targets.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

PAD_ID = 0
SOS_ID = 1
EOS_ID = 2
SEP_ID = 3
NUM_SPECIAL = 4


def _interleave_sep(content: np.ndarray, pen_lift: np.ndarray) -> np.ndarray:
    """Insert SEP after every content token whose point ends a stroke."""
    lift_idx = np.flatnonzero(pen_lift >= 0.5)
    return np.insert(content, lift_idx + 1, SEP_ID)


class GridTokenizer:
    """Quantize absolute point positions onto an R x R spatial grid.

    Encode: integrate deltas to absolute coordinates, min-max normalize the
    sketch into the unit square, floor onto grid cells; cell ``(gx, gy)``
    becomes token ``NUM_SPECIAL + gy * R + gx``. Decode maps tokens back to
    cell centers and re-differentiates. Resolution ~100 matches the
    "grid dictionary-tokenization" regime of the paper/north star.

    Deterministic (no fitted state) — the default tokenizer.
    """

    def __init__(self, resolution: int = 100) -> None:
        if resolution < 2:
            raise ValueError("resolution must be >= 2")
        self.resolution = int(resolution)

    @property
    def vocab_size(self) -> int:
        return NUM_SPECIAL + self.resolution * self.resolution

    # -- geometry helpers -------------------------------------------------
    def _to_unit(self, strokes: np.ndarray) -> np.ndarray:
        coords = np.cumsum(strokes[:, :2], axis=0)
        lo = coords.min(axis=0)
        span = float(max(*(coords.max(axis=0) - lo), 1e-6))
        return (coords - lo) / span

    # -- API --------------------------------------------------------------
    def encode(self, strokes: np.ndarray) -> np.ndarray:
        strokes = np.asarray(strokes, dtype=np.float32)
        if len(strokes) == 0:
            return np.zeros(0, dtype=np.int32)
        unit = self._to_unit(strokes)
        r = self.resolution
        cells = np.clip((unit * r).astype(np.int64), 0, r - 1)
        content = NUM_SPECIAL + cells[:, 1] * r + cells[:, 0]
        return _interleave_sep(content, strokes[:, 2]).astype(np.int32)

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        ids = ids[(ids != PAD_ID) & (ids != SOS_ID)]
        eos = np.flatnonzero(ids == EOS_ID)
        if len(eos):
            ids = ids[: eos[0]]
        r = self.resolution
        is_content = ids >= NUM_SPECIAL
        cells = ids[is_content] - NUM_SPECIAL
        if len(cells) == 0:
            return np.zeros((0, 3), dtype=np.float32)
        coords = np.stack([cells % r, cells // r], axis=1).astype(np.float32)
        coords = (coords + 0.5) / r
        # pen lift: a content token is an end-of-stroke iff the next token is
        # SEP; recover by scanning positions of content tokens in ids.
        content_pos = np.flatnonzero(is_content)
        nxt = np.full(len(content_pos), -1, dtype=np.int64)
        nxt[:-1] = content_pos[:-1] + 1
        pen = np.zeros(len(content_pos), dtype=np.float32)
        within = nxt >= 0
        pen[within] = (ids[nxt[within]] == SEP_ID).astype(np.float32)
        pen[-1] = 1.0
        deltas = np.diff(
            np.concatenate([coords[:1] * 0, coords], axis=0), axis=0
        )
        return np.concatenate([deltas, pen[:, None]], axis=1).astype(np.float32)


class DictionaryTokenizer:
    """Learned codebook over (dx, dy) deltas (k-means, fitted offline).

    Encode: nearest-centroid assignment per pen move — computed as a single
    ``(N, K)`` distance matmul, so the same math vectorizes on-device if
    needed. Decode: centroid lookup. ~1000 entries per the paper.
    """

    def __init__(self, centroids: np.ndarray) -> None:
        centroids = np.asarray(centroids, dtype=np.float32)
        if centroids.ndim != 2 or centroids.shape[1] != 2:
            raise ValueError("centroids must be (K, 2)")
        self.centroids = centroids

    @property
    def vocab_size(self) -> int:
        return NUM_SPECIAL + len(self.centroids)

    # -- fitting (offline, mirrors prep_data/) ----------------------------
    @classmethod
    def fit(
        cls,
        sketches: Sequence[np.ndarray],
        num_tokens: int = 1000,
        iters: int = 25,
        seed: int = 0,
        max_points: int = 200_000,
    ) -> "DictionaryTokenizer":
        rng = np.random.default_rng(seed)
        deltas = np.concatenate([s[:, :2] for s in sketches], axis=0)
        if len(deltas) > max_points:
            deltas = deltas[rng.choice(len(deltas), max_points, replace=False)]
        k = min(num_tokens, len(deltas))
        centroids = deltas[rng.choice(len(deltas), k, replace=False)].copy()
        for _ in range(iters):
            assign = cls._nearest(deltas, centroids)
            for j in range(k):
                members = deltas[assign == j]
                if len(members):
                    centroids[j] = members.mean(axis=0)
        return cls(centroids)

    @staticmethod
    def _nearest(deltas: np.ndarray, centroids: np.ndarray) -> np.ndarray:
        # ||d - c||^2 = ||d||^2 - 2 d.c + ||c||^2 ; argmin ignores ||d||^2.
        scores = deltas @ centroids.T - 0.5 * (centroids**2).sum(axis=1)
        return np.argmax(scores, axis=1)

    # -- API --------------------------------------------------------------
    def encode(self, strokes: np.ndarray) -> np.ndarray:
        strokes = np.asarray(strokes, dtype=np.float32)
        if len(strokes) == 0:
            return np.zeros(0, dtype=np.int32)
        content = NUM_SPECIAL + self._nearest(strokes[:, :2], self.centroids)
        return _interleave_sep(content, strokes[:, 2]).astype(np.int32)

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        ids = ids[(ids != PAD_ID) & (ids != SOS_ID)]
        eos = np.flatnonzero(ids == EOS_ID)
        if len(eos):
            ids = ids[: eos[0]]
        is_content = ids >= NUM_SPECIAL
        deltas = self.centroids[ids[is_content] - NUM_SPECIAL]
        if len(deltas) == 0:
            return np.zeros((0, 3), dtype=np.float32)
        content_pos = np.flatnonzero(is_content)
        pen = np.zeros(len(content_pos), dtype=np.float32)
        nxt = content_pos[:-1] + 1
        pen[:-1] = (ids[nxt] == SEP_ID).astype(np.float32)
        pen[-1] = 1.0
        return np.concatenate([deltas, pen[:, None]], axis=1).astype(np.float32)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, centroids=self.centroids)

    @classmethod
    def load(cls, path: str) -> "DictionaryTokenizer":
        with np.load(path) as data:
            return cls(data["centroids"])


def build_tokenizer(
    kind: str,
    resolution: int = 100,
    dictionary_path: Optional[str] = None,
) -> "GridTokenizer | DictionaryTokenizer":
    if kind == "grid":
        return GridTokenizer(resolution=resolution)
    if kind == "dictionary":
        if dictionary_path is None:
            raise ValueError("dictionary tokenizer requires dictionary_path")
        return DictionaryTokenizer.load(dictionary_path)
    raise ValueError(f"unknown tokenizer kind {kind!r}")


def encode_batch(
    tokenizer, sketches: Sequence[np.ndarray], max_len: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Encode + pad a batch: returns ``(ids (B, max_len), lengths (B,))``.

    Each row is ``[tokens..., EOS, PAD...]`` truncated to ``max_len`` (EOS
    always kept as the final in-range token).
    """
    out = np.full((len(sketches), max_len), PAD_ID, dtype=np.int32)
    lengths = np.zeros(len(sketches), dtype=np.int32)
    for i, s in enumerate(sketches):
        ids = tokenizer.encode(s)
        n = min(len(ids), max_len - 1)
        out[i, :n] = ids[:n]
        out[i, n] = EOS_ID
        lengths[i] = n + 1
    return out, lengths
