"""Embedding extraction: sketches -> fixed-length bottleneck vectors.

Port of ``sketchformer_tpu/infer/encode.py``. ``embed_dataset`` is the
serving loop over loader batches: each batch is copied from pinned host
memory with a non-blocking copy, embedded on the model's device, and its z
is copied back into pinned memory without blocking; results are read two
batches behind (a 3-deep readback queue), so the host prepares batch N+1
while the device works on batch N. Repeat-padded rows (``is_real`` = 0)
are dropped, so a gallery never counts a sketch twice. Under a profiler
each batch is the span ``embed.batch`` and each host copy of its inputs
(pinned on the card) and each pinned z buffer a span ``embed.pin``
(``utils/trace.py``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.utils.trace import span

READBACK_DEPTH = 3


def preprocess_on_device(raw: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, T, 3) absolute-coordinate rows (x, y, pen) -> normalized
    stroke-3 deltas, on whatever device ``raw`` lives."""
    coords = raw[..., :2]
    prev = torch.cat([torch.zeros_like(coords[:, :1]), coords[:, :-1]], dim=1)
    return torch.cat([(coords - prev) / scale, raw[..., 2:]], dim=-1)


def make_embed_fn(model: Sketchformer, fast: bool = True) -> Callable:
    """``embed(enc, enc_mask=None) -> (B, lowerdim)`` f32 on the model's
    device. ``fast=True`` runs supported configs through the kernel stack
    (``infer/fast_encode.py``, which itself falls back for declined
    configs); ``fast=False`` forces the composed model."""
    if fast:
        from sketchformer_tpu_torch.infer.fast_encode import make_fast_embed_fn

        return make_fast_embed_fn(model)

    @torch.inference_mode()
    def embed(enc, enc_mask=None):
        return model.embed(enc, enc_mask)

    return embed


def interpolate(za: np.ndarray, zb: np.ndarray, steps: int = 8) -> np.ndarray:
    """Linear interpolation path between two bottleneck embeddings."""
    alphas = np.linspace(0.0, 1.0, steps, dtype=np.float32)[:, None]
    return (1.0 - alphas) * za[None] + alphas * zb[None]


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    with span("embed.pin"):   # the host copy: pinned where it feeds a card
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory()
    return t.to(device, non_blocking=True)


def embed_dataset(model: Sketchformer, batches: Iterable[dict],
                  fast: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Embed loader batch dicts; returns ``(Z, labels)`` as numpy, real rows
    only."""
    device = next(model.parameters()).device
    embed = make_embed_fn(model, fast)
    cont = model.config.use_continuous
    zs, labels = [], []
    inflight: deque = deque()   # (z host tensor, ready event, label, is_real)

    def drain_one():
        z_host, ready, lab, is_real = inflight.popleft()
        if ready is not None:
            ready.synchronize()
        z = z_host.numpy()
        if is_real is not None:
            keep = np.asarray(is_real) > 0.5
            z, lab = z[keep], lab[keep]
        zs.append(z)
        labels.append(lab)

    for b in batches:
        with span("embed.batch"):
            enc = _to_device(b["enc"], device)
            mask = _to_device(b["enc_mask"], device) if cont else None
            z = embed(enc, mask)
            ready = None
            if device.type == "cuda":
                with span("embed.pin"):
                    z_host = torch.empty(z.shape, dtype=z.dtype,
                                         pin_memory=True)
                z_host.copy_(z, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                z_host = z
            inflight.append((z_host, ready, np.asarray(b["label"]),
                             b.get("is_real")))
            if len(inflight) >= READBACK_DEPTH:
                drain_one()
    while inflight:
        drain_one()
    return np.concatenate(zs, axis=0), np.concatenate(labels, axis=0)
