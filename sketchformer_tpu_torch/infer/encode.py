"""Embedding extraction: sketches -> fixed-length bottleneck vectors.

Port of ``sketchformer_tpu/infer/encode.py``. ``embed_dataset`` is the
serving loop over loader batches: the host finds each batch's valid rows
(``fast_encode.packed_rows``), the batch and their layout are copied from
one pinned host buffer with a non-blocking copy, embedded on the model's
device (the encoder stack on the valid rows alone where the packed stack
takes the batch), and its z is copied back into pinned memory without
blocking; results are read two batches behind (a 3-deep readback queue),
so the host prepares batch N+1 while the device works on batch N.
Repeat-padded rows (``is_real`` = 0) are dropped, so a gallery never
counts a sketch twice. Nothing else in the loop waits on the device: the
host runs up to two batches ahead. Under a profiler each batch is the span
``embed.batch``, the layout's construction a span ``embed.pack``, the
host copy of its inputs (pinned on the card) and each pinned z buffer a
span ``embed.pin``, and the wait for a z two batches behind a span
``embed.drain`` (``utils/trace.py``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, List, Tuple

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
    configs; its ``embed`` also takes a batch's valid rows, ``rows``);
    ``fast=False`` forces the composed model."""
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


def _to_device(arrays: List[np.ndarray],
               device: torch.device) -> List[torch.Tensor]:
    """The host arrays as tensors on ``device``; for a card, one pinned
    buffer holds them all, each from a 16-byte boundary, and one
    non-blocking copy moves it."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets = np.cumsum([0] + [-(-a.nbytes // 16) * 16 for a in arrays])
    with span("embed.pin"):   # the host copy: pinned where it feeds a card
        if device.type != "cuda":
            return [torch.from_numpy(a).to(device) for a in arrays]
        buf = torch.empty(int(offsets[-1]), dtype=torch.uint8,
                          pin_memory=True)
        host = buf.numpy()
        for a, o in zip(arrays, offsets):
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = buf.to(device, non_blocking=True)
    dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in arrays]
    return [buf[o:o + a.nbytes].view(dt).view(a.shape)
            for a, o, dt in zip(arrays, offsets, dtypes)]


def embed_dataset(model: Sketchformer, batches: Iterable[dict],
                  fast: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Embed loader batch dicts; returns ``(Z, labels)`` as numpy, real rows
    only."""
    from sketchformer_tpu_torch.infer.fast_encode import packed_rows

    device = next(model.parameters()).device
    embed = make_embed_fn(model, fast)
    cont = model.config.use_continuous
    zs, labels = [], []
    inflight: deque = deque()   # (z host tensor, ready event, label, is_real)

    def drain_one():
        z_host, ready, lab, is_real = inflight.popleft()
        with span("embed.drain"):   # the host's one wait on the device
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
            host = [np.asarray(b["enc"])]
            if cont:
                host.append(np.asarray(b["enc_mask"]))
            rows = None
            if fast:
                with span("embed.pack"):
                    rows = packed_rows(model, host[0],
                                       host[1] if cont else None, device)
            if rows is not None:
                host += [rows.index.numpy(), rows.work.numpy(),
                         rows.items.numpy()]
            on_device = _to_device(host, device)
            enc = on_device[0]
            mask = on_device[1] if cont else None
            if rows is None:
                z = embed(enc, mask)
            else:
                rows = rows._replace(index=on_device[-3],
                                     work=on_device[-2],
                                     items=on_device[-1])
                z = embed(enc, mask, rows)
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
