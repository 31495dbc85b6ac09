"""Real multi-process execution harness: N local ranks on ``torch.distributed``.

Port of ``sketchformer_tpu/parallel/multiprocess.py``. The data-parallel
path (``parallel/``: the group, the step's reductions, the loop's one
writer, the sharded loader's rank) runs for real in N localhost processes
that meet at a TCP rendezvous:

- on the CPU over gloo;
- on CUDA over NCCL when every rank has a card of its own;
- on CUDA over gloo when the ranks share one card (NCCL refuses two ranks
  on one device).

The backend is chosen explicitly (``parallel.select_backend``) and
reported in each worker's result; a rank that cannot form the group fails
the launch.

Two entry points:

- :func:`launch` — parent side: writes a tiny sharded dataset, spawns the
  workers (``python -m sketchformer_tpu_torch.parallel.multiprocess``),
  collects their JSON results, and raises with every worker's log tail on
  a nonzero exit or a timeout;
- :func:`worker_main` — child side: joins the group, streams this rank's
  disjoint shard subset through ``DistributedStroke3Loader``, and runs one
  scenario: ``steps`` (train steps, an eval batch identical on every rank,
  one checkpoint written by rank 0 and restored by every rank), ``loop``
  (``run_training`` itself) or ``train`` (the train CLI's body on its
  flags, for runs at a preset's width).

The single-process oracle is :func:`reference_losses`: the global batch of
a step is the rank-ordered concatenation of the ranks' batches, so one
process stepping over those concatenations gives the loss trajectory the
ranks must reproduce.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# scenario configuration shared by worker and reference oracle
# ---------------------------------------------------------------------------

SCENARIO = dict(
    local_batch=8,          # per-process batch rows; global = P * local
    bucket=48,
    steps=4,
    grid_resolution=10,
    d_model=32, num_layers=2, num_heads=4, dff=64, lowerdim=16,
    num_queries=2,
)
# the optimizer of the steps scenario (the JAX harness's make_optimizer)
WARMUP_STEPS, PEAK_SCALE = 100, 4.0


def _build_model(num_classes: int, vocab_size: int,
                 init_weights: Optional[str] = None):
    """The scenario's model: parameters from ``init_weights`` (an npz of
    ``convert.save_npz``) or the seeded initialisation of seed 0."""
    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.convert import init_params, load_npz
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    cfg = SketchformerConfig(
        vocab_size=vocab_size, num_classes=num_classes,
        max_len=SCENARIO["bucket"], d_model=SCENARIO["d_model"],
        num_layers=SCENARIO["num_layers"], num_heads=SCENARIO["num_heads"],
        dff=SCENARIO["dff"], dropout=0.0, lowerdim=SCENARIO["lowerdim"],
        num_queries=SCENARIO["num_queries"])
    model = Sketchformer(cfg)
    model.load_state_dict(load_npz(init_weights) if init_weights
                          else init_params(cfg, 0))
    return model


def _loader(data_dir: str, process_index: Optional[int] = None,
            process_count: Optional[int] = None):
    from sketchformer_tpu_torch.data.registry import DistributedStroke3Loader

    return DistributedStroke3Loader(
        data_dir, batch_size=SCENARIO["local_batch"],
        buckets=(SCENARIO["bucket"],),
        grid_resolution=SCENARIO["grid_resolution"], seed=0,
        process_index=process_index, process_count=process_count)


def _first_batches(loader, n: int) -> List[Dict[str, np.ndarray]]:
    out = []
    for b in loader.batch_iterator("train"):
        out.append(b)
        if len(out) >= n:
            break
    return out


def params_digest(state_dict) -> str:
    """sha256 over a ``state_dict``'s names and bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(state_dict):
        h.update(name.encode())
        h.update(np.ascontiguousarray(
            state_dict[name].detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _arrays_digest(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()


def write_scenario_dataset(data_dir: str, num_classes: int = 4,
                           n: int = 256, num_shards: int = 4) -> None:
    """Small deterministic sharded dataset with >= num_shards train shards
    so each of 2 processes streams a disjoint >= 2-shard subset."""
    from sketchformer_tpu_torch.data import synthetic
    from sketchformer_tpu_torch.data.shards import write_shards

    sketches, labels = synthetic.generate_dataset(num_classes, n // num_classes,
                                                  seed=7)
    write_shards(
        data_dir, sketches, np.asarray(labels),
        [f"c{i}" for i in range(num_classes)],
        splits=(0.75, 0.125, 0.125),
        shard_size=max(1, (n * 3 // 4) // num_shards), seed=3)


def concat_batches(batches: Sequence[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """The global batch of one step: the ranks' batches concatenated in
    rank order, each padded with zeros along its time axis to the longest
    bucket among them. Padded positions are PAD tokens or masked
    positions, so the global batch's masked means are those of the ranks'
    rows together."""
    out = {}
    for k in batches[0]:
        arrs = [np.asarray(b[k]) for b in batches]
        if arrs[0].ndim >= 2:
            T = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, [(0, 0), (0, T - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2)) for a in arrs]
        out[k] = np.concatenate(arrs)
    return out


# ---------------------------------------------------------------------------
# worker (subprocess) side
# ---------------------------------------------------------------------------

def worker_main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--init-method", required=True,
                    help="rendezvous, e.g. tcp://localhost:<port>")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True,
                    help="this rank's device: cpu or cuda:<i>")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for the others")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenario", choices=("steps", "loop", "train"),
                    default="steps")
    ap.add_argument("--init-weights", default=None,
                    help="steps and loop scenarios: npz of "
                         "convert.save_npz, every rank's start")
    ap.add_argument("--train-args", default="[]",
                    help="train scenario: JSON list of the train CLI's "
                         "flags (--preset, --hparams, --loader-arg, "
                         "--loop-arg, --notifier)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from sketchformer_tpu_torch import parallel

    dev = torch.device(args.device)
    if dev.type == "cpu":
        # the ranks share the host's cores: one share each, not
        # oversubscribed intra-op pools
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.num_processes))
    parallel.init_process_group(
        args.backend, args.init_method, args.num_processes, args.process_id,
        dev, timeout_s=args.timeout)
    try:
        fn = {"steps": _steps_scenario, "loop": _loop_scenario,
              "train": _train_scenario}[args.scenario]
        result = fn(args, dev)
        result.update(process_index=dist.get_rank(),
                      process_count=dist.get_world_size(),
                      backend=dist.get_backend(), device=str(dev))
        with open(args.out, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _steps_scenario(args, dev) -> Dict:
    """Train steps on this rank's shards, an eval batch identical on every
    rank, one checkpoint written by rank 0 and restored by every rank."""
    from sketchformer_tpu_torch import parallel
    from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
    from sketchformer_tpu_torch.train.step import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    # process-disjoint data: the loader picks its slot from the group
    loader = _loader(args.data_dir)
    if (loader.process_index, loader.process_count) != (
            args.process_id, args.num_processes):
        raise RuntimeError(
            f"the loader streams slot {loader.process_index} of "
            f"{loader.process_count}, not rank {args.process_id} of "
            f"{args.num_processes}")
    model = _build_model(loader.num_classes, loader.vocab_size,
                         args.init_weights).to(dev)
    batches = _first_batches(loader, SCENARIO["steps"])
    state = create_train_state(model, 0, WARMUP_STEPS, PEAK_SCALE)
    step = make_train_step(state)
    losses = [float(step(b)["loss"]) for b in batches]

    # eval: every rank reads the WHOLE val split (loader policy)
    val = loader.get_validation_set(max_batches=1)[0]
    val_loss = float(make_eval_step(model)(val)["loss"])

    ckpt = CheckpointManager(args.run_dir)
    wrote = False
    if parallel.is_main():
        ckpt.save_config(model.config)
        wrote = ckpt.save(state, force=True)
    parallel.barrier()
    fresh = _build_model(loader.num_classes, loader.vocab_size,
                         args.init_weights).to(dev)
    restored = ckpt.restore(create_train_state(fresh, 0, WARMUP_STEPS,
                                               PEAK_SCALE))
    digest = params_digest(model.state_dict())
    return dict(
        losses=losses,
        val_loss=val_loss,
        save_returned=bool(wrote),
        restored_step=int(restored.step),
        restored_equal=params_digest(fresh.state_dict()) == digest,
        params_digest=digest,
        ckpt_steps=ckpt.all_steps(),
        # the train stream is process-DISJOINT (shard striding): it must
        # differ between ranks, while the val digest must agree
        train_stream_digest=_arrays_digest(
            {f"b{i}": b["enc"] for i, b in enumerate(batches)}),
        val_batch_digest=_arrays_digest({"enc": val["enc"]}),
    )


def _loop_scenario(args, dev) -> Dict:
    """Drive the production train loop (train/loop.py run_training) across
    the group: reduced steps + checkpoint cadence + one writer (rank 0) +
    an eval feed identical on every rank."""
    from sketchformer_tpu_torch.train.loop import TrainLoopConfig, run_training

    loader = _loader(args.data_dir)
    model = _build_model(loader.num_classes, loader.vocab_size,
                         args.init_weights).to(dev)
    loop_cfg = TrainLoopConfig(
        total_steps=6, eval_every=3, save_every=3, log_every=2,
        notify_every=6, warmup_steps=10, peak_scale=2.0, seed=0)
    run_dir = os.path.join(args.run_dir, "loop")
    final = run_training(model, loader, run_dir, loop_cfg)
    return dict(
        final=dict(final),
        params_digest=params_digest(model.state_dict()),
        metrics_jsonl_exists=os.path.exists(
            os.path.join(run_dir, "metrics.jsonl")),
        config_exists=os.path.exists(os.path.join(run_dir, "config.json")),
    )


def _train_scenario(args, dev) -> Dict:
    """The train CLI's body (``cli.train``) on ``--train-args`` (its
    ``--preset``, ``--hparams``, ``--loader-arg``, ``--loop-arg`` and
    ``--notifier`` flags) and the harness's data and run dirs; then every
    rank restores the checkpoint rank 0 wrote into a fresh model. Reports
    the final eval metrics, the params digest, the checkpoint steps, the
    seconds of the run and this rank's kernel launches in it."""
    import torch

    from sketchformer_tpu_torch import cli, ops
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer
    from sketchformer_tpu_torch.train.checkpoint import CheckpointManager

    cargs = cli.build_parser().parse_args(
        ["train", *json.loads(args.train_args), "--data-dir", args.data_dir,
         "--run-dir", args.run_dir, "--device", str(dev)])
    ops.reset_launches()
    t0 = time.perf_counter()
    model, final = cli.train(cargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    ckpt = CheckpointManager(args.run_dir)
    restored = Sketchformer(model.config).to(dev)
    restored.load_state_dict(ckpt.load_state_dict()["params"])
    digest = params_digest(model.state_dict())
    return dict(
        final=dict(final), params_digest=digest,
        restored_equal=params_digest(restored.state_dict()) == digest,
        ckpt_steps=ckpt.all_steps(), launches=launches, seconds=seconds)


# ---------------------------------------------------------------------------
# parent (harness) side
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_devices(device: str, n_processes: int):
    """(backend, one device a rank): CPU ranks on gloo; CUDA ranks on a
    card each over NCCL where there are enough cards, else all on card 0
    over gloo."""
    from sketchformer_tpu_torch import parallel

    if device == "cpu":
        return parallel.select_backend("cpu", False), ["cpu"] * n_processes
    import torch

    shared = torch.cuda.device_count() < n_processes
    devs = ["cuda:0" if shared else f"cuda:{r}" for r in range(n_processes)]
    return parallel.select_backend("cuda", shared), devs


def launch(workdir: str, n_processes: int = 2, timeout: float = 120.0,
           scenario: str = "steps", device: str = "cpu",
           init_weights: Optional[str] = None,
           data_dir: Optional[str] = None,
           train_args: Sequence[str] = ()) -> List[Dict]:
    """Run the N workers to completion on ``data_dir`` (default: the
    scenario dataset, written under ``workdir``) and return their parsed
    result dicts, ordered by rank. Each worker has ``timeout`` seconds;
    raises RuntimeError with every worker's log tail on a nonzero exit or
    a timeout."""
    if data_dir is None:
        data_dir = os.path.join(workdir, "data")
        if not os.path.exists(os.path.join(data_dir, "meta.npz")):
            write_scenario_dataset(data_dir)
    run_dir = os.path.join(workdir, "run")
    os.makedirs(run_dir, exist_ok=True)
    backend, devs = rank_devices(device, n_processes)

    init_method = f"tcp://localhost:{free_port()}"
    procs, outs, logs = [], [], []
    env = dict(os.environ)
    # repo root on the path for `python -m sketchformer_tpu_torch...`
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    for pid in range(n_processes):
        out = os.path.join(workdir, f"worker_{scenario}_{pid}.json")
        log = open(os.path.join(workdir, f"worker_{scenario}_{pid}.log"), "w")
        outs.append(out)
        logs.append(log)
        cmd = [sys.executable, "-m", "sketchformer_tpu_torch.parallel."
               "multiprocess", "--process-id", str(pid),
               "--num-processes", str(n_processes),
               "--init-method", init_method, "--backend", backend,
               "--device", devs[pid], "--timeout", str(timeout),
               "--data-dir", data_dir, "--run-dir", run_dir, "--out", out,
               "--scenario", scenario, "--train-args",
               json.dumps(list(train_args))]
        if init_weights:
            cmd += ["--init-weights", init_weights]
        procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    rcs: List[Optional[int]] = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.monotonic(),
                                              0.1)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rc != 0 for rc in rcs):
        tails = []
        for pid in range(n_processes):
            rc = "timed out" if rcs[pid] is None else f"rc={rcs[pid]}"
            with open(os.path.join(workdir,
                                   f"worker_{scenario}_{pid}.log")) as f:
                tails.append(f"--- worker {pid} ({rc}) ---\n"
                             + "".join(f.readlines()[-30:]))
        raise RuntimeError("multiprocess workers failed\n" + "\n".join(tails))
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def reference_losses(workdir: str, n_processes: int = 2,
                     init_weights: Optional[str] = None) -> List[float]:
    """Single-process oracle: per step, the global batch is the rank-
    ordered concat of the ranks' loader streams; one process stepping over
    those concats (no group) yields the trajectory the ranks must match."""
    from sketchformer_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    data_dir = os.path.join(workdir, "data")
    streams = [_first_batches(_loader(data_dir, pid, n_processes),
                              SCENARIO["steps"])
               for pid in range(n_processes)]
    loader0 = _loader(data_dir, process_index=0, process_count=n_processes)
    model = _build_model(loader0.num_classes, loader0.vocab_size,
                         init_weights)
    state = create_train_state(model, 0, WARMUP_STEPS, PEAK_SCALE)
    step = make_train_step(state)
    return [float(step(concat_batches([s[i] for s in streams]))["loss"])
            for i in range(SCENARIO["steps"])]


if __name__ == "__main__":
    worker_main()
