"""Checkpoints on ``torch.save``: save, auto-resume, config snapshot.

Port of ``sketchformer_tpu/train/checkpoint.py`` with the JAX run-dir
layout: ``config.json`` and ``run_meta.json`` at the top of the run dir and
one directory per saved step under ``checkpoints/``
(``checkpoints/<step>/state.pt`` here, where orbax writes its own files).
A checkpoint holds the FULL train state: parameters, optimizer state (count
and moments), step and the dropout seed. Saves are synchronous, keep the
newest ``max_to_keep``, and honour ``save_interval_steps`` unless forced;
``save_on_signal`` installs a SIGTERM handler that saves before the process
exits. In a process group rank 0 alone saves and installs the handler
(``train/loop.py``); every rank restores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
from typing import Any, Callable, List, Optional

import torch

from sketchformer_tpu_torch.train.step import TrainState

STATE_FILE = "state.pt"


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, run_dir: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> None:
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    # -- config snapshot ---------------------------------------------------
    def save_config(self, config: Any) -> None:
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2)

    def load_config_dict(self) -> Optional[dict]:
        path = os.path.join(self.run_dir, "config.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save_meta(self, meta: dict) -> None:
        """Run metadata beyond the model config (e.g. the loader config);
        merges with what is there."""
        merged = self.load_meta()
        merged.update(meta)
        with open(os.path.join(self.run_dir, "run_meta.json"), "w") as f:
            json.dump(merged, f, indent=2)

    def load_meta(self) -> dict:
        path = os.path.join(self.run_dir, "run_meta.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    # -- state save/restore ------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.ckpt_dir)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.ckpt_dir, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, force: bool = False) -> bool:
        step = int(state.step)
        if step in self.all_steps():
            return False  # already on disk (a forced save after a policy one)
        if not force and step % self.save_interval_steps:
            return False
        final = os.path.join(self.ckpt_dir, str(step))
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save(_cpu({"params": state.model.state_dict(),
                         "opt_state": state.opt.state_dict(),
                         "step": step, "rng": state.seed}),
                   os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # a reader never sees half a checkpoint
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
        return True

    def load_state_dict(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        return torch.load(os.path.join(self.ckpt_dir, str(step), STATE_FILE),
                          map_location="cpu")

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into ``state``'s model and optimizer (on their
        device) and return the state at that step."""
        saved = self.load_state_dict(step)
        state.model.load_state_dict(saved["params"])
        state.opt.load_state_dict(saved["opt_state"])
        state.step = int(saved["step"])
        state.seed = int(saved["rng"])
        return state

    # -- preemption safety -------------------------------------------------
    def save_on_signal(self, get_state: Callable[[], Optional[TrainState]],
                       signals=(signal.SIGTERM,)) -> None:
        """Install handlers that save synchronously before exiting."""

        def handler(signum, frame):
            state = get_state()
            if state is not None:
                self.save(state, force=True)
            raise SystemExit(128 + signum)

        for s in signals:
            signal.signal(s, handler)
