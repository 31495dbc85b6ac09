"""Multi-process data parallelism on ``torch.distributed``.

Every rank holds the whole model and trains on its own rows of the global
batch; there is no model or tensor sharding. The train step
(``train/step.py``) and loop (``train/loop.py``) read the process group
through these helpers, and :mod:`sketchformer_tpu_torch.parallel.multiprocess`
starts ranks on one host. The backend is chosen explicitly
(:func:`select_backend`) and never changed behind the caller's back: a rank
that cannot form its group raises.
"""

from __future__ import annotations

import datetime
from typing import Tuple

import torch
import torch.distributed as dist


def group_active() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if not group_active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    """Rank 0, the one writer of a run dir (every process without a
    group)."""
    return rank_and_world()[0] == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if group_active():
        dist.barrier()


def select_backend(device: torch.device, shared_card: bool) -> str:
    """gloo for CPU tensors; NCCL for CUDA tensors when every rank has a
    card of its own; gloo for CUDA tensors when ranks share one card
    (NCCL refuses two ranks on one device)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no backend for device {device}")
    return "gloo" if shared_card else "nccl"


def init_process_group(backend: str, init_method: str, world_size: int,
                       rank: int, device: torch.device,
                       timeout_s: float = 300.0) -> None:
    """Join the group at ``init_method`` (``tcp://localhost:<port>``) as
    ``rank`` of ``world_size`` on ``backend``, with ``device`` as this
    rank's device. Raises if the group cannot form within ``timeout_s``."""
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
