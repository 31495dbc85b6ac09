"""Registered validation metrics: scalar + plot metrics on val slices.

Capability parity with the reference's metric framework (reference:
core/metrics.py — a registry of metric classes, each computed on a
validation slice during training and pushed to TensorBoard/notifier; both
scalar metrics and plot metrics such as reconstruction grids and latent
interpolations).

Port of ``sketchformer_tpu/train/val_metrics.py``. A metric is a small
class with ``kind`` ("scalar" | "image") and ``compute(ctx)``; the train
loop builds one :class:`MetricContext` and runs whichever metrics
``TrainLoopConfig.metrics`` names. All device work goes through the port's
inference engines (the kernel embed and the chunk decoders).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from sketchformer_tpu_torch.utils.registry import Registry

val_metrics: Registry = Registry("val_metric")


@dataclasses.dataclass
class MetricContext:
    """Everything a registered metric may need, with cached callables.

    ``model`` is the port's torch module, which holds its own parameters.
    Metrics run the model in eval mode under ``torch.inference_mode``
    through the same engines as the inference API (kernel embed, chunk
    decoders); ``cache`` persists across cadences for the life of the run.
    """

    model: Any
    loader: Any
    step: int
    rng_seed: int = 0
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- cached device callables ------------------------------------------
    def embed_fn(self):
        if "embed" not in self.cache:
            from sketchformer_tpu_torch.infer.encode import make_embed_fn

            self.cache["embed"] = make_embed_fn(self.model)
        return self.cache["embed"]

    def token_decoder_from_z(self):
        if "tok_dec_z" not in self.cache:
            from sketchformer_tpu_torch.infer import decode as dec

            self.cache["tok_dec_z"] = dec.make_token_decoder_from_z(self.model)
        return self.cache["tok_dec_z"]

    def cont_decoder_from_z(self):
        if "cont_dec_z" not in self.cache:
            from sketchformer_tpu_torch.infer import decode as dec

            self.cache["cont_dec_z"] = dec.make_cont_decoder_from_z(self.model)
        return self.cache["cont_dec_z"]

    def _device(self):
        return next(self.model.parameters()).device

    def val_batch(self):
        return self.loader.get_validation_set(max_batches=1)[0]

    def embed_batch(self, batch) -> np.ndarray:
        import torch

        dev = self._device()
        enc = torch.from_numpy(np.asarray(batch["enc"])).to(dev)
        mask = None
        if self.model.config.use_continuous:
            mask = torch.from_numpy(np.asarray(batch["enc_mask"])).to(dev)
        with torch.inference_mode():
            z = self.embed_fn()(enc, mask)
        return z.float().cpu().numpy()

    def decode_from_z(self, z: np.ndarray) -> list:
        """Decode embeddings -> list of stroke-3 sketches (either mode)."""
        import torch

        from sketchformer_tpu_torch.infer import decode as dec

        dev = self._device()
        zt = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
        with torch.inference_mode():
            if self.model.config.use_continuous:
                gen = torch.Generator(device=dev).manual_seed(self.rng_seed)
                xy, pen, valid = self.cont_decoder_from_z()(zt, gen)
                return dec.cont_to_sketches(
                    xy.cpu().numpy(), pen.cpu().numpy(), valid.cpu().numpy(),
                    scale=getattr(self.loader, "scale", 1.0))
            ids = self.token_decoder_from_z()(zt)
        return dec.tokens_to_sketches(self.loader.tokenizer, ids.cpu())


class ValMetric:
    """Base class; subclasses set ``name``/``kind`` and implement compute.

    ``kind='scalar'`` -> compute returns ``Dict[str, float]``;
    ``kind='image'``  -> compute returns an (H, W) float image in [0, 1].
    """

    name: str = "metric"
    kind: str = "scalar"

    def compute(self, ctx: MetricContext):
        raise NotImplementedError


@val_metrics.register("recon_grid")
class ReconGridMetric(ValMetric):
    """2-row original/reconstruction grid via the KV-cached AR decoder
    (reference parity: the reconstruction plot metric)."""

    name = "reconstruction"
    kind = "image"

    def compute(self, ctx: MetricContext):
        from sketchformer_tpu_torch.utils.metrics import reconstruction_grid

        batch = ctx.val_batch()
        z = ctx.embed_batch(batch)
        recon = ctx.decode_from_z(z)
        if ctx.model.config.use_continuous:
            # originals from the normalized continuous encoder input
            scale = getattr(ctx.loader, "scale", 1.0)
            orig = []
            for i in range(min(8, len(batch["enc"]))):
                rows = batch["enc"][i][batch["enc_mask"][i] > 0.5]
                sk = np.asarray(rows, np.float32).copy()
                sk[:, :2] *= scale
                orig.append(sk)
        else:
            orig = [ctx.loader.tokenizer.decode(row)
                    for row in np.asarray(batch["enc"][:8])]
        return reconstruction_grid(orig, recon)


@val_metrics.register("interpolation_grid")
class InterpolationGridMetric(ValMetric):
    """Latent interpolation strip between two val sketches (reference
    parity: the paper's interpolation capability as a plot metric)."""

    name = "interpolation"
    kind = "image"
    steps: int = 8

    def compute(self, ctx: MetricContext):
        from sketchformer_tpu_torch.infer.encode import interpolate
        from sketchformer_tpu_torch.utils.metrics import sketch_strip

        batch = ctx.val_batch()
        z = ctx.embed_batch(batch)
        # endpoints: first two sketches with distinct labels when possible
        j = 1
        labels = np.asarray(batch["label"])
        distinct = np.flatnonzero(labels != labels[0])
        if len(distinct):
            j = int(distinct[0])
        path = interpolate(z[0], z[j], steps=self.steps)
        # decode the whole path as one batch (static shape = steps)
        sketches = ctx.decode_from_z(path.astype(z.dtype))
        return sketch_strip(sketches)


@val_metrics.register("retrieval")
class RetrievalMetric(ValMetric):
    """Small SBIR-style retrieval eval on val embeddings (top-1/mAP)."""

    name = "retrieval"
    kind = "scalar"
    max_batches: int = 4

    def compute(self, ctx: MetricContext):
        from sketchformer_tpu_torch.infer.sbir import retrieval_eval

        batches = ctx.loader.get_validation_set(max_batches=self.max_batches)
        zs, labels = [], []
        for b in batches:
            z, lab = ctx.embed_batch(b), np.asarray(b["label"])
            if "is_real" in b:   # drop repeat-padded duplicate rows
                keep = np.asarray(b["is_real"]) > 0.5
                z, lab = z[keep], lab[keep]
            zs.append(z)
            labels.append(lab)
        Z = np.concatenate(zs, axis=0)
        L = np.concatenate(labels, axis=0)
        m = retrieval_eval(Z, L, Z, L, exclude_self=True)
        return {"retrieval_top1": m["top1"], "retrieval_mAP": m["mAP"]}


@val_metrics.register("embedding_stats")
class EmbeddingStatsMetric(ValMetric):
    """Health scalars of the bottleneck embedding distribution."""

    name = "embedding_stats"
    kind = "scalar"

    def compute(self, ctx: MetricContext):
        z = ctx.embed_batch(ctx.val_batch()).astype(np.float64)
        norms = np.linalg.norm(z, axis=1)
        zc = z - z.mean(axis=0, keepdims=True)
        # mean absolute off-diagonal correlation: collapse indicator
        cov = (zc.T @ zc) / max(len(z) - 1, 1)
        d = np.sqrt(np.maximum(np.diag(cov), 1e-12))
        corr = cov / np.outer(d, d)
        off = corr[~np.eye(len(corr), dtype=bool)]
        return {
            "z_norm_mean": float(norms.mean()),
            "z_norm_std": float(norms.std()),
            "z_offdiag_corr": float(np.abs(off).mean()),
        }


def build_metrics(names) -> list:
    """Comma-string or iterable of registered names -> metric instances."""
    if isinstance(names, str):
        names = [n.strip() for n in names.split(",") if n.strip()]
    return [val_metrics.get(n)() for n in names]
