"""Multi-task losses: reconstruction (GMM NLL + pen CE) + classification CE.

Port of ``classification_loss`` and ``cont_multitask_loss`` of
``sketchformer_tpu/train/loss.py``, with the same metric keys. All losses
run in f32 on the f32 head outputs. ``is_real`` (B,) row weights, when a
batch has them, zero repeat-padded duplicate rows out of every term.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sketchformer_tpu_torch.ops import mdn


def classification_loss(
    logits: torch.Tensor, labels: torch.Tensor,
    row_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE, accuracy) of (B, C) logits against (B,) int labels."""
    logits = logits.float()
    log_probs = torch.log_softmax(logits, dim=-1)
    ll = log_probs.gather(-1, labels.long()[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == labels).float()
    if row_weights is None:
        return -ll.mean(), correct.mean()
    rw = row_weights.float()
    denom = torch.clamp(rw.sum(), min=1.0)
    return -(ll * rw).sum() / denom, (correct * rw).sum() / denom


def cont_multitask_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_mixtures: int,
    w_recon: float = 1.0,
    w_cls: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Continuous mode: (total, metrics) with keys loss, recon_loss,
    gmm_nll, pen_ce, cls_loss, cls_acc."""
    rw = batch.get("is_real")
    dec_mask = batch["dec_mask"]
    if rw is not None:
        # zero duplicate rows' positions: mdn_loss normalises by mask sum
        dec_mask = dec_mask * rw[:, None]
    nll_xy, nll_pen = mdn.mdn_loss(outputs["recon"], num_mixtures,
                                   batch["tgt_xy"], batch["tgt_pen"],
                                   dec_mask)
    cls, cls_acc = classification_loss(outputs["cls"], batch["label"],
                                       row_weights=rw)
    recon = nll_xy + nll_pen
    total = w_recon * recon + w_cls * cls
    return total, {
        "loss": total,
        "recon_loss": recon,
        "gmm_nll": nll_xy,
        "pen_ce": nll_pen,
        "cls_loss": cls,
        "cls_acc": cls_acc,
    }
