"""Packed batches: ship only what the device cannot derive.

Port of ``sketchformer_tpu/data/packed.py``. :func:`pack_batch` (numpy, on
the host) reduces a pipeline batch to the stroke rows, per-sketch lengths,
labels and ``is_real``; :func:`unpack_batch` rebuilds the continuous
batch's masks, targets and shifted decoder rows with torch ops on whatever
device the packed tensors lie, an exact mirror of ``make_batch_tok`` and
``make_batch_cont`` (``data/pipeline.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sketchformer_tpu_torch.data.tokenizer import SOS_ID

PEN_END = 2
_SOS_ROW = (0.0, 0.0, 0.0, 1.0, 0.0)  # pipeline.SOS_ROW: "pen just lifted"


def is_packed(batch: Dict[str, Any]) -> bool:
    return "dec_in" not in batch


def pack_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Full pipeline batch -> minimal wire dict (host-side). Already-packed
    batches pass through."""
    if is_packed(batch):
        return batch
    wire = {"enc": batch["enc"], "label": batch["label"]}
    if "is_real" in batch:
        wire["is_real"] = batch["is_real"]
    if "enc_mask" in batch:  # cont mode: rows (B, T, C)
        # n real rows per sketch == enc_mask row sum (the builder reserves
        # the n-th position for the END target, so dec_mask = n+1 ones)
        wire["n"] = np.asarray(
            batch["enc_mask"]).sum(axis=-1).astype(np.int32)
    return wire


def unpack_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Packed batch (torch tensors) -> the full batch."""
    if not is_packed(batch):
        return batch
    enc = batch["enc"]
    out = dict(batch)
    if "n" not in batch:  # token ids: shift right, SOS first; PAD carries
        out["dec_in"] = torch.cat(
            [torch.full_like(enc[:, :1], SOS_ID), enc[:, :-1]], dim=1)
        out["dec_tgt"] = enc
        return out
    n = out.pop("n")
    B, T = enc.shape[:2]
    pos = torch.arange(T, dtype=torch.int32, device=enc.device)[None, :]
    real = pos < n[:, None]
    enc_mask = real.float()
    dec_mask = (pos < (n + 1)[:, None]).float()
    tgt_xy = enc[..., :2].float()
    tgt_pen = torch.where(real, (enc[..., 2] >= 0.5).int(),
                          torch.full_like(pos, PEN_END))
    pen_oh = torch.nn.functional.one_hot(tgt_pen[:, :-1].long(), 3).float()
    # the builder zeroes the one-hot on rows past the END target
    pen_oh = pen_oh * dec_mask[:, :-1, None]
    sos = torch.tensor(_SOS_ROW, dtype=torch.float32,
                       device=enc.device).expand(B, 1, 5)
    dec_in = torch.cat([sos, torch.cat([tgt_xy[:, :-1], pen_oh], dim=-1)],
                       dim=1)
    out.update(enc_mask=enc_mask, dec_mask=dec_mask, tgt_xy=tgt_xy,
               tgt_pen=tgt_pen, dec_in=dec_in)
    return out
