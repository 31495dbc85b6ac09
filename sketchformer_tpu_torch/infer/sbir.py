"""SBIR-style retrieval evaluation over bottleneck embeddings.

Capability parity with the reference's SBIR / embedding-extraction eval
(reference: embedding-dump + retrieval-eval scripts; the paper evaluates
sketch-based image retrieval with the bottleneck embedding as the query
representation). Without image branches in this environment the harness
evaluates sketch->sketch retrieval over a gallery: cosine kNN, top-k
accuracy, and mAP — the same machinery a cross-modal gallery would use
(drop-in: swap gallery embeddings for image-branch embeddings).

The kNN score matrix is one (Q, D) x (D, G) matmul — device-friendly; the
ranking metrics are host-side numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def retrieval_eval(
    query_z: np.ndarray,
    query_labels: np.ndarray,
    gallery_z: np.ndarray,
    gallery_labels: np.ndarray,
    topk: tuple = (1, 5, 10),
    exclude_self: bool = False,
) -> Dict[str, float]:
    """Cosine-similarity retrieval metrics: top-k accuracy and mAP.

    ``exclude_self`` drops the diagonal (query == gallery evaluation).
    """
    q = _normalize_rows(query_z.astype(np.float64))
    g = _normalize_rows(gallery_z.astype(np.float64))
    sims = q @ g.T  # (Q, G)
    if exclude_self:
        np.fill_diagonal(sims, -np.inf)
    order = np.argsort(-sims, axis=1)
    ranked_labels = gallery_labels[order]  # (Q, G)
    match = ranked_labels == query_labels[:, None]
    if exclude_self:
        match = match[:, :-1]  # last column is the -inf self slot

    out: Dict[str, float] = {}
    for k in topk:
        out[f"top{k}"] = float(match[:, :k].any(axis=1).mean())

    # mAP over all relevant gallery items per query
    relevant = match.sum(axis=1)
    precision_at = np.cumsum(match, axis=1) / np.arange(1, match.shape[1] + 1)
    ap = np.where(
        relevant > 0,
        (precision_at * match).sum(axis=1) / np.maximum(relevant, 1),
        0.0,
    )
    out["mAP"] = float(ap.mean())
    return out


def classification_eval(
    logits_or_z_knn: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    """Top-1/top-5 classification accuracy from class logits."""
    order = np.argsort(-logits_or_z_knn, axis=1)
    top1 = float((order[:, 0] == labels).mean())
    top5 = float((order[:, :5] == labels[:, None]).any(axis=1).mean())
    return {"top1": top1, "top5": top5}
