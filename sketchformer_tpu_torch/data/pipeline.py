"""Batch assembly: length-bucketed padding and model-ready batch dicts.

Capability parity with the reference's per-batch host work (reference:
dataloaders/distributed_stroke3.py — per batch: tokenize (dict mode) or keep
continuous, pad to batch max or cap at max_seq_len, yield
(input, shifted target, class label)).

TPU-first re-design:
- The reference pads each batch to its own max length -> a new XLA program
  per distinct length. Here lengths snap to a FIXED bucket set (default
  32/64/96/128/192/256), bounding both padding waste and compile count; each
  bucket's batch shape is static so jit compiles once per bucket.
- Batches are plain dicts of numpy arrays; the train step jits over them
  with donated buffers. Normalization/delta math is vectorized (numpy on
  host for assembly; the same ops exist as jnp transforms for the on-device
  benchmark path in :mod:`sketchformer_tpu_torch.infer.encode`).

Token-mode batch dict::

    enc      int32 (B, L)   encoder tokens, EOS-terminated, PAD-padded
    dec_in   int32 (B, L)   [SOS, t_1 .. t_{L-1}]
    dec_tgt  int32 (B, L)   [t_1 .. EOS, PAD...]
    label    int32 (B,)

Continuous-mode batch dict::

    enc      float32 (B, L, 3)  normalized stroke-3, zero-padded
    enc_mask float32 (B, L)     1 on real encoder rows
    dec_in   float32 (B, L, 5)  stroke-5 shifted right with SOS row
    tgt_xy   float32 (B, L, 2)
    tgt_pen  int32   (B, L)     0=down, 1=lift, 2=end-of-sketch
    dec_mask float32 (B, L)     1 on real target rows (incl. the end row)
    label    int32   (B,)
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from sketchformer_tpu_torch.data import stroke3
from sketchformer_tpu_torch.data.tokenizer import (
    EOS_ID,
    PAD_ID,
    SOS_ID,
    GridTokenizer,
    encode_batch,
)

DEFAULT_BUCKETS = (32, 64, 96, 128, 192, 256)

PEN_DOWN, PEN_LIFT, PEN_END = 0, 1, 2
SOS_ROW = np.array([0, 0, 0, 1, 0], dtype=np.float32)  # "pen just lifted"


def bucket_for_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n, else the largest bucket (sequence truncates)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# ---------------------------------------------------------------------------
# batch builders
# ---------------------------------------------------------------------------


def _ragged_concat(sketches: Sequence[np.ndarray]):
    offsets = np.zeros(len(sketches) + 1, np.int64)
    offsets[1:] = np.cumsum([len(s) for s in sketches])
    points = (
        np.concatenate(sketches, axis=0).astype(np.float32)
        if offsets[-1]
        else np.zeros((0, 3), np.float32)
    )
    return np.ascontiguousarray(points), offsets


def make_batch_tok(
    tokenizer,
    sketches: Sequence[np.ndarray],
    labels: np.ndarray,
    max_len: int,
    native: bool = True,
) -> Dict[str, np.ndarray]:
    ids = None
    if native and isinstance(tokenizer, GridTokenizer):
        from sketchformer_tpu_torch.native import get_batcher

        mod = get_batcher()
        if mod is not None:
            points, offsets = _ragged_concat(sketches)
            ids, _ = mod.grid_encode_batch(
                points, offsets, tokenizer.resolution, max_len)
    if ids is None:
        ids, _ = encode_batch(tokenizer, sketches, max_len)
    dec_in = np.full_like(ids, PAD_ID)
    dec_in[:, 0] = SOS_ID
    dec_in[:, 1:] = ids[:, :-1]
    return {
        "enc": ids,
        "dec_in": dec_in,
        "dec_tgt": ids,
        "label": labels.astype(np.int32),
    }


def make_batch_cont(
    sketches: Sequence[np.ndarray],
    labels: np.ndarray,
    max_len: int,
    scale: float,
    native: bool = True,
) -> Dict[str, np.ndarray]:
    if native:
        from sketchformer_tpu_torch.native import get_batcher

        mod = get_batcher()
        if mod is not None:
            points, offsets = _ragged_concat(
                [np.asarray(s, np.float32) for s in sketches])
            enc, enc_mask, dec_in, tgt_xy, tgt_pen, dec_mask = mod.cont_batch(
                points, offsets, float(scale), max_len)
            return {
                "enc": enc, "enc_mask": enc_mask, "dec_in": dec_in,
                "tgt_xy": tgt_xy, "tgt_pen": tgt_pen, "dec_mask": dec_mask,
                "label": labels.astype(np.int32),
            }
    B = len(sketches)
    enc = np.zeros((B, max_len, 3), dtype=np.float32)
    enc_mask = np.zeros((B, max_len), dtype=np.float32)
    tgt_xy = np.zeros((B, max_len, 2), dtype=np.float32)
    tgt_pen = np.full((B, max_len), PEN_END, dtype=np.int32)
    dec_mask = np.zeros((B, max_len), dtype=np.float32)
    for i, s in enumerate(sketches):
        s = stroke3.normalize(np.asarray(s, dtype=np.float32), scale)
        n = min(len(s), max_len - 1)  # reserve one row for the end marker
        enc[i, :n] = s[:n]
        enc_mask[i, :n] = 1.0
        tgt_xy[i, :n] = s[:n, :2]
        tgt_pen[i, :n] = (s[:n, 2] >= 0.5).astype(np.int32)  # 0 down / 1 lift
        # row n is the PEN_END target (tgt_xy stays 0)
        dec_mask[i, : n + 1] = 1.0
    dec_in = np.zeros((B, max_len, 5), dtype=np.float32)
    dec_in[:, 0] = SOS_ROW
    dec_in[:, 1:, :2] = tgt_xy[:, :-1]
    pen_oh = np.eye(3, dtype=np.float32)[tgt_pen[:, :-1]]
    # zero out one-hot on padded prefix rows so padding stays all-zero
    pen_oh *= dec_mask[:, :-1, None]
    dec_in[:, 1:, 2:] = pen_oh
    return {
        "enc": enc,
        "enc_mask": enc_mask,
        "dec_in": dec_in,
        "tgt_xy": tgt_xy,
        "tgt_pen": tgt_pen,
        "dec_mask": dec_mask,
        "label": labels.astype(np.int32),
    }


# ---------------------------------------------------------------------------
# bucketed batching
# ---------------------------------------------------------------------------


class BucketBatcher:
    """Group (sketch, label) pairs into fixed-shape bucketed batches.

    ``token_mode`` controls which batch builder runs. Partial leftovers are
    flushed (repeated-padded up to batch_size) when ``drain`` is called, so
    every sketch is seen and every emitted batch has the static shape.
    """

    def __init__(
        self,
        batch_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        token_mode: bool = True,
        tokenizer=None,
        scale: float = 1.0,
        token_len_factor: float = None,  # unused; kept for call compat
    ) -> None:
        if token_mode and tokenizer is None:
            raise ValueError("token_mode requires a tokenizer")
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.token_mode = token_mode
        self.tokenizer = tokenizer
        self.scale = scale
        self._pending: Dict[int, Tuple[List[np.ndarray], List[int]]] = {
            b: ([], []) for b in self.buckets
        }
        # truncation observability ("no silent caps"): sketches longer than
        # the largest bucket truncate at batch build; count them here so the
        # train loop can surface ``truncated_frac`` as a metric.
        self.n_added = 0
        self.n_truncated = 0

    @property
    def truncated_frac(self) -> float:
        return self.n_truncated / max(self.n_added, 1)

    def _emit(self, bucket: int) -> Dict[str, np.ndarray]:
        sketches, labels = self._pending[bucket]
        self._pending[bucket] = ([], [])
        n_real = len(sketches)
        for k in range(self.batch_size - n_real):  # pad short final batches
            sketches.append(sketches[k % n_real])  # cycle through ALL reals
            labels.append(labels[k % n_real])
        labels_arr = np.asarray(labels, dtype=np.int32)
        if self.token_mode:
            batch = make_batch_tok(
                self.tokenizer, sketches, labels_arr, bucket)
        else:
            batch = make_batch_cont(sketches, labels_arr, bucket, self.scale)
        # row-validity mask: repeat-padded rows (duplicated sketches that
        # only exist to fill the static batch shape) are 0 so eval metrics,
        # embedding dumps, and SBIR galleries never double-count a sketch.
        batch["is_real"] = (
            np.arange(self.batch_size) < n_real).astype(np.float32)
        return batch

    def add(self, sketch: np.ndarray, label: int):
        n = len(sketch)
        if self.token_mode:
            # EXACT token count: one content token per point, one SEP per
            # pen-lift point, plus EOS (both tokenizers share this layout) —
            # no estimate factor, so bucketing never under-provisions.
            n_sep = int((np.asarray(sketch)[:, 2] >= 0.5).sum()) if n else 0
            n = n + n_sep + 1
        else:
            n = n + 1  # one row reserved for the PEN_END target
        self.n_added += 1
        if n > self.buckets[-1]:
            self.n_truncated += 1
        b = bucket_for_length(n, self.buckets)
        sketches, labels = self._pending[b]
        sketches.append(sketch)
        labels.append(label)
        if len(sketches) >= self.batch_size:
            return self._emit(b)
        return None

    def drain(self) -> Iterator[Dict[str, np.ndarray]]:
        for b in self.buckets:
            if self._pending[b][0]:
                yield self._emit(b)


def iterate_batches(
    pairs: Iterator[Tuple[np.ndarray, int]],
    batcher: BucketBatcher,
    drain: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    for sketch, label in pairs:
        batch = batcher.add(sketch, label)
        if batch is not None:
            yield batch
    if drain:
        yield from batcher.drain()


class Prefetcher:
    """Background-thread batch prefetch (bounded queue).

    Host-side shard reads + batch assembly run ahead of the training loop so
    the device never waits on the host (the reference assembles batches
    synchronously on the step path). Used by train/loop.py; iterate normally
    and ``close()`` (or exhaust) to join the thread.
    """

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 4) -> None:
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None

        def worker() -> None:
            try:
                for item in iterator:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surface producer errors to consumer
                self._error = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise RuntimeError(
                    "data pipeline worker failed") from self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # unblock the worker if it's waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        self._thread.join(timeout=5)
