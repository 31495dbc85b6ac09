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
  ``skipped_nonfinite`` is 1 (the norm is read on the host once a step to
  decide);
- ``accum_steps > 1`` splits the batch's rows into that many microbatches
  and averages their gradients and metrics before one update.

Not ported: ``steps_per_call`` (it amortised host dispatch on a remote
TPU), ``mesh`` / ``explicit_spmd`` (one card) and ``remat`` (the fused
stacks already save only their layers' inputs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from sketchformer_tpu_torch.data.packed import pack_batch, unpack_batch
from sketchformer_tpu_torch.models.dropout import use_generator
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.train import loss as losses
from sketchformer_tpu_torch.train.schedule import NoamAdam, global_norm


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
    params = [p for p in model.parameters()]
    opt = NoamAdam(params, model.config.d_model, warmup_steps=warmup_steps,
                   peak_scale=peak_scale)
    return TrainState(model, opt, 0, seed)


def dropout_context(device, seed: int, step: int, micro: int = 0):
    """The dropout state of one (micro)step: the generator of its CPU draws
    and the seed key of the card's Philox draws."""
    s = np.random.SeedSequence([seed, step, micro]).generate_state(
        1, np.uint64)[0]
    return use_generator(torch.Generator(device=device).manual_seed(int(s)),
                         seed_key=(seed, step, micro))


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Packed numpy batch -> torch tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
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


def make_train_step(state: TrainState, w_recon: float = 1.0,
                    w_cls: float = 1.0, accum_steps: int = 1) -> Callable:
    """``step(batch) -> metrics`` (0-d tensors on the device): one update
    of ``state`` from a packed or full batch (numpy or torch)."""
    model = state.model
    params = list(model.parameters())
    dev = params[0].device

    def grads_for(batch, micro):
        for p in params:
            p.grad = None
        with dropout_context(dev, state.seed, state.step, micro):
            total, metrics = _forward_loss(model, batch, w_recon, w_cls)
        total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
                 for p in params]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def step(batch) -> Dict[str, torch.Tensor]:
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
        grad_norm = global_norm(grads)
        applied = state.opt.step(grads, grad_norm)
        metrics["grad_norm"] = grad_norm
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if applied else 1.0,
                                                    device=dev)
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
