"""TFRecord shard IO — the alternative on-disk format the north star names
("streams tokenized sketches from sharded npz/TFRecord").

TensorFlow is used ONLY here (serialization), imported lazily so the rest of
the framework has no TF dependency. Each example holds one sketch::

    points: float32 bytes of the (N, 3) stroke-3 array
    n:      int64 row count
    label:  int64 class id

plus the same ``meta.npz`` sidecar as the npz format (class names, sigma) so
:class:`TFRecordSketchDataset` exposes the identical reader interface as
``ShardedDataset`` and registers as the ``tfrecord_stroke3`` dataloader.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from sketchformer_tpu_torch.data import stroke3
from sketchformer_tpu_torch.data.pipeline import DEFAULT_BUCKETS
from sketchformer_tpu_torch.data.registry import BaseLoader, dataloaders
from sketchformer_tpu_torch.data.shards import SPLITS


def _tf():
    import tensorflow as tf  # lazy: only for TFRecord serialization

    return tf


def write_tfrecord_shards(
    out_dir: str,
    sketches: Sequence[np.ndarray],
    labels: np.ndarray,
    class_names: Sequence[str],
    splits: Tuple[float, float, float] = (0.9, 0.05, 0.05),
    shard_size: int = 2048,
    seed: int = 0,
    scale: float | None = None,
) -> None:
    tf = _tf()
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
        train = [sketches[i] for i in split_idx["train"]] or list(sketches)
        scale = stroke3.compute_deviation(train)

    counts = {}
    for split, idx in split_idx.items():
        num_shards = max(1, -(-len(idx) // shard_size))
        counts[split] = num_shards
        for s in range(num_shards):
            chunk = idx[s * shard_size : (s + 1) * shard_size]
            path = os.path.join(out_dir, f"{split}_{s:04d}.tfrecord")
            with tf.io.TFRecordWriter(path) as w:
                for i in chunk:
                    sk = np.asarray(sketches[i], dtype=np.float32)
                    ex = tf.train.Example(features=tf.train.Features(feature={
                        "points": tf.train.Feature(bytes_list=tf.train.BytesList(
                            value=[sk.tobytes()])),
                        "n": tf.train.Feature(int64_list=tf.train.Int64List(
                            value=[len(sk)])),
                        "label": tf.train.Feature(int64_list=tf.train.Int64List(
                            value=[int(labels[i])])),
                    }))
                    w.write(ex.SerializeToString())
    np.savez(
        os.path.join(out_dir, "meta.npz"),
        class_names=np.asarray(list(class_names)),
        scale=np.float32(scale),
        **{f"num_shards_{k}": np.int64(v) for k, v in counts.items()},
    )


class TFRecordSketchDataset:
    """Reader mirroring ShardedDataset's interface over .tfrecord shards."""

    def __init__(self, data_dir: str) -> None:
        self.data_dir = data_dir
        with np.load(os.path.join(data_dir, "meta.npz")) as meta:
            self.class_names: List[str] = [str(c) for c in meta["class_names"]]
            self.scale = float(meta["scale"])
            self.num_shards = {
                split: int(meta[f"num_shards_{split}"]) for split in SPLITS
            }

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def shard_path(self, split: str, index: int) -> str:
        return os.path.join(self.data_dir, f"{split}_{index:04d}.tfrecord")

    def iter_sketches(
        self,
        split: str,
        shuffle_shards: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Tuple[np.ndarray, int]]:
        # multi-host DP stride over shards — same contract as
        # ShardedDataset.iter_sketches (disjoint subsets per process)
        tf = _tf()
        if not (0 <= process_index < process_count):
            raise ValueError(
                f"process_index={process_index} out of range for "
                f"process_count={process_count}")
        order = np.arange(self.num_shards[split])
        if shuffle_shards:
            np.random.default_rng(seed).shuffle(order)
        order = order[process_index::process_count]
        feature_spec = {
            "points": tf.io.FixedLenFeature([], tf.string),
            "n": tf.io.FixedLenFeature([], tf.int64),
            "label": tf.io.FixedLenFeature([], tf.int64),
        }
        for s in order:
            ds = tf.data.TFRecordDataset(self.shard_path(split, int(s)))
            for raw in ds:
                ex = tf.io.parse_single_example(raw, feature_spec)
                pts = np.frombuffer(
                    ex["points"].numpy(), dtype=np.float32
                ).reshape(int(ex["n"]), 3)
                yield pts, int(ex["label"])


@dataloaders.register("tfrecord_stroke3")
class TFRecordStroke3Loader(BaseLoader):
    """Streams TFRecord shards; same bucketed-batch interface as npz."""

    def __init__(
        self,
        data_dir: str,
        token_mode: bool = True,
        batch_size: int = 64,
        buckets=DEFAULT_BUCKETS,
        tokenizer=None,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        self.dataset = TFRecordSketchDataset(data_dir)
        super().__init__(
            token_mode=token_mode, batch_size=batch_size, buckets=buckets,
            tokenizer=tokenizer, seed=seed)
        self.num_classes = self.dataset.num_classes
        self.class_names = self.dataset.class_names
        self.scale = self.dataset.scale
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    def iter_pairs(self, split: str, epoch: int = 0):
        train = split == "train"
        return self.dataset.iter_sketches(
            split, shuffle_shards=train, seed=self.seed + epoch,
            process_index=self.process_index if train else 0,
            process_count=self.process_count if train else 1)
