"""The train and eval steps.

Port of ``sketchformer_tpu/train/step.py`` for one card, token and
continuous (MDN) mode. A step unpacks the packed batch on the device
(``data/packed.py``), runs the model in training mode, back-propagates the
multi-task loss, and applies
:class:`~sketchformer_tpu_torch.train.schedule.NoamAdam`. Token mode runs
``Sketchformer.forward_tok_loss`` (the CE inside the model, on the K6
kernels under ``attn_impl='pallas'``) with ``is_real`` as row weights;
continuous mode runs the teacher-forced forward and the MDN loss.

Dropout is keyed by (seed, step) and the microbatch index: on the CPU every
site draws from a generator derived from them; on the card each dropout
call (the fused stacks' in-kernel Philox draws, the composed sites' emits)
takes a seed derived on the host from them and the call's index
(``models/dropout.py``), so no device value is read to draw it.

- ``grad_norm`` is the global norm of the unclipped gradients;
- the non-finite guard rejects an update whose gradient norm is not
  finite: parameters and optimizer state stay as they were, and
  ``skipped_nonfinite`` is 1; the norm, the guard and the update run on
  the device (``train/schedule.py``), so no value is read on the host to
  decide;
- ``accum_steps > 1`` splits the batch's rows into that many microbatches
  and averages their gradients and metrics before one update.

Data parallelism: inside an initialised ``torch.distributed`` group
(``parallel/``) every rank's step computes what one process computes on
the global batch, the concatenation of the ranks' batches, as the JAX
step does over a mesh:

- each loss term is a weighted mean; the ranks' weight sums
  (``loss.mean_denominators``) are all-reduced before the backward and
  each rank's means scaled to its share of the global means, so the shares
  add up to the global loss whatever token counts the ranks hold;
- one all-reduce a step sums the flattened f32 gradients and the metrics,
  so the gradient norm, the non-finite guard and the logged metrics are
  the same on every rank;
- dropout keys fold in the rank when the world is larger than one (a world
  of one keeps the keys of a run without a group).

Under a profiler (``utils/trace.py``) a step is the span ``train.step``;
inside it ``train.h2d`` (a host batch's copy to the device),
``train.forward`` and ``train.backward`` (each microbatch's launches),
``train.guard`` (the gradient norm's launch) and ``train.update`` (the
guarded, clipped Adam update's launches).

Not ported: ``steps_per_call`` (it amortised host dispatch on a remote
TPU), ``mesh`` / ``explicit_spmd`` (GSPMD sharding; data parallelism is
the process group above) and ``remat`` (the fused stacks already save only
their layers' inputs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sketchformer_tpu_torch import parallel
from sketchformer_tpu_torch.data.packed import pack_batch, unpack_batch
from sketchformer_tpu_torch.models.dropout import use_generator
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.train import loss as losses
from sketchformer_tpu_torch.train.schedule import (
    NoamAdam,
    global_norm,
    make_optimizer,
)
from sketchformer_tpu_torch.utils.trace import span


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the model (its parameters), the optimizer,
    the step and the dropout seed (each step's generator is derived from
    (seed, step), as the JAX step folds the step into ``state.rng``)."""

    model: Sketchformer
    opt: NoamAdam
    step: int
    seed: int


def create_train_state(model: Sketchformer, seed: int, warmup_steps: int,
                       peak_scale: float) -> TrainState:
    opt = make_optimizer(list(model.parameters()), model.config.d_model,
                         warmup_steps=warmup_steps, peak_scale=peak_scale)
    return TrainState(model, opt, 0, seed)


def dropout_context(device, seed: int, step: int, micro: int = 0,
                    rank: Optional[int] = None):
    """The dropout state of one (micro)step: the generator of its CPU draws
    and the seed key of the card's Philox draws; ``rank`` (a data-parallel
    rank in a world larger than one) is folded into both."""
    key = (seed, step, micro) + (() if rank is None else (rank,))
    s = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]
    return use_generator(torch.Generator(device=device).manual_seed(int(s)),
                         seed_key=key)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Packed numpy batch -> torch tensors on ``device``."""
    with span("train.h2d"):
        return {k: torch.as_tensor(np.asarray(v)).to(device,
                                                      non_blocking=True)
                for k, v in pack_batch(batch).items()}


def _forward_loss(model, batch, w_recon, w_cls):
    """(total, metrics) of the multi-task loss of ``batch`` (unpacked)."""
    cfg = model.config
    if not cfg.use_continuous:
        outputs = model.forward_tok_loss(
            enc=batch["enc"], dec_in=batch["dec_in"],
            dec_tgt=batch["dec_tgt"], row_weights=batch.get("is_real"))
        return losses.tok_multitask_loss_fused(outputs, batch,
                                               w_recon=w_recon, w_cls=w_cls)
    outputs = model(enc=batch["enc"], dec_in=batch["dec_in"],
                    enc_mask=batch["enc_mask"],
                    dec_key_mask=batch["dec_mask"])
    return losses.cont_multitask_loss(
        outputs, batch, num_mixtures=cfg.num_mixtures, w_recon=w_recon,
        w_cls=w_cls)


# metrics that are means over rows (the rest are means over the
# reconstruction terms' tokens or positions)
_ROW_MEANS = ("cls_loss", "cls_acc")


def global_shares(model, batch, metrics: Dict[str, torch.Tensor],
                  w_recon: float, w_cls: float
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) of this rank's share of the global batch: each
    weighted mean scaled by this rank's weight sum over the ranks' (one
    all-reduce), so that the ranks' shares add up to the means over the
    global batch. The weight sums are clamped to >= 1 as the losses clamp
    them."""
    local = losses.mean_denominators(
        batch, continuous=model.config.use_continuous)
    total = local.clone()
    dist.all_reduce(total)
    recon_f, rows_f = local.clamp_min(1.0) / total.clamp_min(1.0)
    shares = {k: v * (rows_f if k in _ROW_MEANS else recon_f)
              for k, v in metrics.items() if k != "loss"}
    shares["loss"] = w_recon * shares["recon_loss"] + w_cls * shares["cls_loss"]
    return shares["loss"], shares


def all_reduce_sum(grads: List[torch.Tensor],
                   metrics: Dict[str, torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Sum the f32 gradients and the metrics over the ranks with one
    all-reduce of one flat buffer; every rank gets the same sums."""
    keys = sorted(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].float() for k in keys])])
    dist.all_reduce(flat)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out, dict(zip(keys, flat[at:].unbind()))


def make_train_step(state: TrainState, w_recon: float = 1.0,
                    w_cls: float = 1.0, accum_steps: int = 1) -> Callable:
    """``step(batch) -> metrics`` (0-d tensors on the device): one update
    of ``state`` from a packed or full batch (numpy or torch). Inside an
    initialised process group the batch is this rank's rows of the global
    batch, and the update and metrics are the global batch's."""
    model = state.model
    params = list(model.parameters())
    dev = params[0].device
    group = parallel.group_active()
    rank, world = parallel.rank_and_world()
    drop_rank = rank if world > 1 else None

    def grads_for(batch, micro):
        for p in params:
            p.grad = None
        with dropout_context(dev, state.seed, state.step, micro, drop_rank):
            with span("train.forward"):
                total, metrics = _forward_loss(model, batch, w_recon, w_cls)
                if group:
                    total, metrics = global_shares(model, batch, metrics,
                                                   w_recon, w_cls)
        with span("train.backward"):
            total.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
                     for p in params]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def step(batch) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            return one_step(batch)

    def one_step(batch) -> Dict[str, torch.Tensor]:
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = batch_to_device(batch, dev)
        batch = unpack_batch(batch)
        model.train()
        if accum_steps == 1:
            grads, metrics = grads_for(batch, 0)
        else:
            B = batch["enc"].shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by accum_steps "
                                 f"{accum_steps}")
            mb = B // accum_steps
            grads = metrics = None
            for i in range(accum_steps):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, m = grads_for(part, i)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = [a + b for a, b in zip(grads, g)]
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / accum_steps for g in grads]
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        for p in params:
            p.grad = None
        if group:
            grads, metrics = all_reduce_sum(grads, metrics)
        with span("train.guard"):
            grad_norm = global_norm(grads)
        applied = state.opt.step(grads, grad_norm)
        metrics["grad_norm"] = grad_norm
        metrics["skipped_nonfinite"] = 1.0 - torch.as_tensor(
            applied, dtype=torch.float32, device=dev)
        state.step += 1
        return metrics

    return step


def make_eval_step(model: Sketchformer, w_recon: float = 1.0,
                   w_cls: float = 1.0) -> Callable:
    """``eval_step(batch) -> metrics``: the model in eval mode (fused
    inference kernels, no dropout), no gradients."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def step(batch) -> Dict[str, torch.Tensor]:
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = batch_to_device(batch, dev)
        batch = unpack_batch(batch)
        model.eval()
        _, metrics = _forward_loss(model, batch, w_recon, w_cls)
        return metrics

    return step
