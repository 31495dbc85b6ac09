"""The experiment loop: training with eval, checkpointing, notification.

Port of ``sketchformer_tpu/train/loop.py`` for one card. The bucket stream
runs on a background thread (``Prefetcher``); each batch is packed on the
host (``data/packed.py``) and expanded on the device inside the step.
Metrics are read back to the host only at the log cadence, so the host
keeps launching while the device works. Cadences (log / eval / save /
notify / registered val metrics) fire when the step crosses a multiple of
their period; the run resumes from the newest checkpoint in its run dir.

Registered val metrics (``train/val_metrics.py``): ``retrieval`` and
``embedding_stats`` (the kernel embed), ``recon_grid`` and
``interpolation_grid`` (the chunk decoders) all run on ported paths.

``profile_steps`` traces steps [start + 10, start + 10 + N) of the run
with ``torch.profiler`` (``utils/metrics.py::profile_block``) into
``run_dir/profile``; the trace holds the program's spans
(``utils/trace.py``): ``train.data_wait`` (the wait for the next host
batch) and each step's ``train.step`` with its parts.

Multi-process runs (an initialised ``torch.distributed`` group, as
``parallel/multiprocess.py`` forms it): every rank drives the same loop on
its own rows of the global batch (the step reduces over the group), but
the run dir has ONE writer. Rank 0 owns ``config.json``, ``run_meta.json``,
``metrics.jsonl``, the notifier, the registered val metrics, the SIGTERM
save and every checkpoint write; a barrier follows each save, and every
rank restores on resume. Eval reads the whole val split on every rank (the
loader's policy), so val metrics agree without a reduction.

Not ported: ``steps_per_call``, ``device_prefetch`` (its asynchronous
staging answered a remote TPU's blocking ``device_put``), ``remat``,
``mesh`` (GSPMD sharding), ``prng_impl`` (the card's dropout draws from
the Philox streams of ``ops/dropout_prng.py``, the CPU's from a
``torch.Generator``) and ``recon_grid_every`` (name ``recon_grid`` in
``metrics``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from sketchformer_tpu_torch import parallel
from sketchformer_tpu_torch.data.pipeline import Prefetcher
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
from sketchformer_tpu_torch.train.step import (
    batch_to_device,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from sketchformer_tpu_torch.utils.metrics import (
    MetricWriter,
    NullMetricWriter,
    StepTimer,
    profile_block,
)
from sketchformer_tpu_torch.utils.notify import Notifier, NullNotifier
from sketchformer_tpu_torch.utils.trace import span


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 10_000
    eval_every: int = 500
    save_every: int = 1000
    notify_every: int = 1000
    log_every: int = 50
    warmup_steps: int = 4000
    peak_scale: float = 1.0
    w_recon: float = 1.0
    w_cls: float = 1.0
    seed: int = 0
    resume: bool = True
    accum_steps: int = 1
    # registered val metrics (train/val_metrics.py), comma-separated names;
    # run every metrics_every steps (0 -> at eval_every cadence)
    metrics: str = ""
    metrics_every: int = 0
    profile_steps: int = 0      # trace steps [10, 10+N) with torch.profiler


def evaluate(eval_step, batches) -> Dict[str, float]:
    """Mean of each eval metric over ``batches``, on the host."""
    acc: Dict[str, torch.Tensor] = {}
    for b in batches:
        for k, v in eval_step(b).items():
            acc[k] = acc[k] + v if k in acc else v
    return {k: float(v) / max(len(batches), 1) for k, v in acc.items()}


def run_training(
    model: Sketchformer,
    loader,
    run_dir: str,
    loop_cfg: Optional[TrainLoopConfig] = None,
    notifier: Optional[Notifier] = None,
    max_eval_batches: int = 8,
) -> Dict[str, float]:
    """Train ``model`` (its parameters already on their device) to
    ``total_steps``; returns the final eval metrics. Inside a process
    group, build ``loader`` after the group formed, so that a sharded
    loader streams this rank's shards."""
    loop_cfg = loop_cfg or TrainLoopConfig()
    is_main = parallel.is_main()
    notifier = (notifier or NullNotifier()) if is_main else NullNotifier()
    dev = next(model.parameters()).device
    state = create_train_state(model, loop_cfg.seed, loop_cfg.warmup_steps,
                               loop_cfg.peak_scale)
    train_step = make_train_step(state, w_recon=loop_cfg.w_recon,
                                 w_cls=loop_cfg.w_cls,
                                 accum_steps=loop_cfg.accum_steps)
    eval_step = make_eval_step(model, w_recon=loop_cfg.w_recon,
                               w_cls=loop_cfg.w_cls)

    def batch_stream():
        epoch = 0
        while True:
            yield from loader.batch_iterator("train", epoch=epoch)
            epoch += 1

    stream = Prefetcher(batch_stream(), depth=4)
    ckpt = CheckpointManager(run_dir, save_interval_steps=loop_cfg.save_every)
    if is_main:
        ckpt.save_config(model.config)
    if loop_cfg.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    if is_main:
        ckpt.save_on_signal(lambda: state)

    def save(force: bool = False) -> None:
        if is_main:
            ckpt.save(state, force=force)
        parallel.barrier()

    writer = MetricWriter(run_dir) if is_main else NullMetricWriter()
    timer = StepTimer()
    last_metrics: Dict[str, float] = {}
    last_eval_step = -1

    def run_eval() -> Dict[str, float]:
        batches = loader.get_validation_set(max_batches=max_eval_batches)
        ev = evaluate(eval_step, [batch_to_device(b, dev) for b in batches])
        return {f"val_{k}": v for k, v in ev.items()}

    from sketchformer_tpu_torch.train.val_metrics import (
        MetricContext,
        build_metrics,
    )

    registered = build_metrics(loop_cfg.metrics)
    metric_ctx = MetricContext(model=model, loader=loader, step=0,
                               rng_seed=loop_cfg.seed)
    metrics_every = loop_cfg.metrics_every or loop_cfg.eval_every

    def run_registered_metrics(step):
        if not is_main:
            return
        metric_ctx.step = step
        for m in registered:
            out = m.compute(metric_ctx)
            if m.kind == "image":
                writer.write_image(step, m.name, out)
                notifier.notify(f"{m.name} grid @ step {step}", image=out)
            else:
                writer.write_scalars(step, out)
                last_metrics.update(out)

    start_step = state.step
    trace = contextlib.ExitStack()
    profiling = False
    while state.step < loop_cfg.total_steps:
        if loop_cfg.profile_steps:
            if not profiling and state.step == start_step + 10:
                trace.enter_context(profile_block(run_dir, enabled=True))
                profiling = True
            elif profiling and (state.step
                                == start_step + 10 + loop_cfg.profile_steps):
                trace.close()
        with span("train.data_wait"):
            batch = next(stream)
        metrics = train_step(batch_to_device(batch, dev))
        step = state.step
        timer.tick()
        if step % loop_cfg.log_every == 0 or step == start_step + 1:
            host = {k: float(v) for k, v in metrics.items()}
            host["steps_per_sec"] = timer.steps_per_sec()
            if hasattr(loader, "truncation_stats"):
                seen, trunc = loader.truncation_stats()
                host["truncated_frac"] = trunc / max(seen, 1)
            writer.write_scalars(step, host)
            last_metrics = host
        if step % loop_cfg.eval_every == 0:
            ev = run_eval()
            writer.write_scalars(step, ev)
            last_metrics.update(ev)
            last_eval_step = step
        if step % loop_cfg.notify_every == 0:
            notifier.notify(f"step {step}", scalars=last_metrics)
        if registered and step % metrics_every == 0:
            run_registered_metrics(step)
        if step % loop_cfg.save_every == 0:
            save()
    trace.close()

    if last_eval_step == state.step:
        final = {k: v for k, v in last_metrics.items()
                 if k.startswith("val_")}
    else:
        final = run_eval()
        writer.write_scalars(state.step, final)
    save(force=True)
    writer.close()
    stream.close()
    return final
