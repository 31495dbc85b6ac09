"""Sharded dataset on disk: class-mixed npz shards + metadata.

Capability parity with the reference's offline prep + "distributed stroke3"
format (reference: prep_data/ shard-writer scripts and
dataloaders/distributed_stroke3.py — per-class QuickDraw npz files are
shuffled into K class-mixed shards per split, with a metadata file holding
class names and the normalization sigma).

Format. Each shard ``{split}_{i:04d}.npz`` holds::

    points:  (total_points, 3) float32  — all sketches concatenated
    offsets: (num_sketches + 1,) int64  — sketch i = points[offsets[i]:offsets[i+1]]
    labels:  (num_sketches,) int32

plus ``meta.npz`` with ``class_names`` (unicode array), ``scale`` (sigma),
``num_shards_{train,valid,test}``. The ragged concat layout keeps shard files
dense and mmap-friendly (one contiguous read per shard, no per-sketch pickle
objects) — sequential HBM-feeding reads on the host side.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from sketchformer_tpu_torch.data import stroke3

SPLITS = ("train", "valid", "test")


def write_shards(
    out_dir: str,
    sketches: Sequence[np.ndarray],
    labels: np.ndarray,
    class_names: Sequence[str],
    splits: Tuple[float, float, float] = (0.9, 0.05, 0.05),
    shard_size: int = 2048,
    seed: int = 0,
    scale: float | None = None,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(sketches))
    n = len(sketches)
    n_train = int(splits[0] * n)
    n_valid = int(splits[1] * n)
    split_idx = {
        "train": perm[:n_train],
        "valid": perm[n_train : n_train + n_valid],
        "test": perm[n_train + n_valid :],
    }
    if scale is None:
        train_sketches = [sketches[i] for i in split_idx["train"]] or list(sketches)
        scale = stroke3.compute_deviation(train_sketches)

    counts = {}
    for split, idx in split_idx.items():
        num_shards = max(1, -(-len(idx) // shard_size))
        counts[split] = num_shards
        for s in range(num_shards):
            chunk = idx[s * shard_size : (s + 1) * shard_size]
            sks = [np.asarray(sketches[i], dtype=np.float32) for i in chunk]
            offsets = np.zeros(len(sks) + 1, dtype=np.int64)
            offsets[1:] = np.cumsum([len(x) for x in sks])
            points = (
                np.concatenate(sks, axis=0)
                if sks
                else np.zeros((0, 3), np.float32)
            )
            np.savez(
                os.path.join(out_dir, f"{split}_{s:04d}.npz"),
                points=points,
                offsets=offsets,
                labels=labels[chunk].astype(np.int32),
            )
    np.savez(
        os.path.join(out_dir, "meta.npz"),
        class_names=np.asarray(list(class_names)),
        scale=np.float32(scale),
        **{f"num_shards_{k}": np.int64(v) for k, v in counts.items()},
    )


class ShardedDataset:
    """Reader over a directory written by :func:`write_shards`."""

    def __init__(self, data_dir: str) -> None:
        self.data_dir = data_dir
        meta_path = os.path.join(data_dir, "meta.npz")
        with np.load(meta_path, allow_pickle=False) as meta:
            self.class_names: List[str] = [str(c) for c in meta["class_names"]]
            self.scale = float(meta["scale"])
            self.num_shards = {
                split: int(meta[f"num_shards_{split}"]) for split in SPLITS
            }

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def shard_path(self, split: str, index: int) -> str:
        return os.path.join(self.data_dir, f"{split}_{index:04d}.npz")

    def read_shard(
        self, split: str, index: int
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        with np.load(self.shard_path(split, index)) as data:
            points = data["points"]
            offsets = data["offsets"]
            labels = data["labels"]
        sketches = [
            points[offsets[i] : offsets[i + 1]] for i in range(len(labels))
        ]
        return sketches, labels

    def iter_sketches(
        self,
        split: str,
        shuffle_shards: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Stream ``(sketch, label)`` pairs shard by shard.

        Multi-host DP: each process strides the (identically seeded)
        shuffled shard order by ``(process_index, process_count)`` so every
        host reads a DISJOINT shard subset — without this every host would
        feed identical data and data parallelism would train on 1/N the
        effective dataset (SURVEY.md §2 parallel table, DP row).
        """
        if not (0 <= process_index < process_count):
            raise ValueError(
                f"process_index={process_index} out of range for "
                f"process_count={process_count}")
        order = np.arange(self.num_shards[split])
        if shuffle_shards:
            np.random.default_rng(seed).shuffle(order)
        order = order[process_index::process_count]
        for s in order:
            sketches, labels = self.read_shard(split, int(s))
            for sk, lb in zip(sketches, labels):
                yield sk, int(lb)
