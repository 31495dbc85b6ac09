"""Registered dataloaders: sharded-npz streams and synthetic generation.

Capability parity with the reference's dataloader registry + distributed
stroke-3 loader (reference: dataloaders/__init__.py name->class lookup;
dataloaders/distributed_stroke3.py — shard streaming with shard shuffling,
per-batch tokenize/pad, validation-set access, class-label metadata).

The ``synthetic`` loader exists because this environment has no network (no
real QuickDraw); it generates class-structured sketches on the fly so every
config is runnable end-to-end.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from sketchformer_tpu_torch.data import synthetic
from sketchformer_tpu_torch.data.pipeline import (
    DEFAULT_BUCKETS,
    BucketBatcher,
    iterate_batches,
)
from sketchformer_tpu_torch.data.shards import ShardedDataset
from sketchformer_tpu_torch.data.tokenizer import GridTokenizer, build_tokenizer
from sketchformer_tpu_torch.utils.registry import Registry

dataloaders: Registry = Registry("dataloader")


def get_dataloader_by_name(name: str):
    return dataloaders.get(name)


class BaseLoader:
    """Common interface every registered loader provides.

    ``batch_iterator(split)`` yields model-ready batch dicts with static
    bucketed shapes; ``get_validation_set(n)`` returns a bounded list of
    batches reused across eval passes.
    """

    num_classes: int
    class_names: List[str]
    scale: float

    def __init__(
        self,
        token_mode: bool = True,
        batch_size: int = 64,
        buckets=DEFAULT_BUCKETS,
        tokenizer=None,
        seed: int = 0,
    ) -> None:
        self.token_mode = token_mode
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.tokenizer = tokenizer or GridTokenizer()
        self.seed = seed
        self._val_cache: Optional[List[Dict[str, np.ndarray]]] = None
        self._val_exhausted = False
        # cumulative truncation counters across train epochs ("no silent
        # caps"): surfaced by the train loop as the truncated_frac metric
        self._trunc_added = 0
        self._trunc_truncated = 0
        self._active_batcher: Optional[BucketBatcher] = None

    # subclasses implement:
    def iter_pairs(self, split: str, epoch: int = 0):
        raise NotImplementedError

    def _batcher(self) -> BucketBatcher:
        return BucketBatcher(
            batch_size=self.batch_size,
            buckets=self.buckets,
            token_mode=self.token_mode,
            tokenizer=self.tokenizer,
            scale=self.scale,
        )

    def batch_iterator(
        self, split: str = "train", epoch: int = 0, drain: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        batcher = self._batcher()
        if split == "train":
            if self._active_batcher is not None:
                self._trunc_added += self._active_batcher.n_added
                self._trunc_truncated += self._active_batcher.n_truncated
            self._active_batcher = batcher
        yield from iterate_batches(
            self.iter_pairs(split, epoch), batcher, drain=drain
        )

    def truncation_stats(self) -> "tuple[int, int]":
        """Cumulative ``(sketches_seen, sketches_truncated)`` over all train
        iteration so far (sketches longer than the largest bucket)."""
        a, t = self._trunc_added, self._trunc_truncated
        if self._active_batcher is not None:
            a += self._active_batcher.n_added
            t += self._active_batcher.n_truncated
        return a, t

    def get_validation_set(
        self, max_batches: int = 8
    ) -> List[Dict[str, np.ndarray]]:
        cached_enough = self._val_cache is not None and (
            len(self._val_cache) >= max_batches or self._val_exhausted)
        if not cached_enough:
            out = []
            exhausted = True
            for batch in self.batch_iterator("valid"):
                out.append(batch)
                if len(out) >= max_batches:
                    exhausted = False
                    break
            self._val_cache = out
            self._val_exhausted = exhausted
        return self._val_cache[:max_batches]

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size


@dataloaders.register("distributed_stroke3")
class DistributedStroke3Loader(BaseLoader):
    """Streams class-mixed npz shards written by ``prep_data``."""

    def __init__(
        self,
        data_dir: str,
        token_mode: bool = True,
        batch_size: int = 64,
        buckets=DEFAULT_BUCKETS,
        tokenizer_kind: str = "grid",
        grid_resolution: int = 100,
        dictionary_path: Optional[str] = None,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ) -> None:
        self.dataset = ShardedDataset(data_dir)
        # multi-process DP: default to this process's rank in an initialised
        # torch.distributed group so each process streams a disjoint shard
        # subset (lazy import: the data layer stays importable without torch)
        if process_index is None or process_count is None:
            process_index, process_count = 0, 1
            try:
                import torch.distributed as dist

                if dist.is_available() and dist.is_initialized():
                    process_index = dist.get_rank()
                    process_count = dist.get_world_size()
            except ImportError:
                pass
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        tokenizer = build_tokenizer(
            tokenizer_kind,
            resolution=grid_resolution,
            dictionary_path=dictionary_path,
        )
        super().__init__(
            token_mode=token_mode,
            batch_size=batch_size,
            buckets=buckets,
            tokenizer=tokenizer,
            seed=seed,
        )
        self.num_classes = self.dataset.num_classes
        self.class_names = self.dataset.class_names
        self.scale = self.dataset.scale

    def iter_pairs(self, split: str, epoch: int = 0):
        # eval splits are read whole on every host (metrics must agree);
        # only the train stream is process-sharded
        train = split == "train"
        return self.dataset.iter_sketches(
            split, shuffle_shards=train, seed=self.seed + epoch,
            process_index=self.process_index if train else 0,
            process_count=self.process_count if train else 1,
        )


@dataloaders.register("synthetic")
class SyntheticLoader(BaseLoader):
    """On-the-fly class-structured synthetic sketches (no disk, no network)."""

    def __init__(
        self,
        num_classes: int = 16,
        sketches_per_epoch: int = 2048,
        token_mode: bool = True,
        batch_size: int = 64,
        buckets=DEFAULT_BUCKETS,
        tokenizer=None,
        seed: int = 0,
    ) -> None:
        super().__init__(
            token_mode=token_mode,
            batch_size=batch_size,
            buckets=buckets,
            tokenizer=tokenizer,
            seed=seed,
        )
        self.num_classes = num_classes
        self.class_names = [f"class_{i:03d}" for i in range(num_classes)]
        self.sketches_per_epoch = sketches_per_epoch
        # sigma from a probe sample, mirroring prep-time computation
        probe, _ = synthetic.generate_dataset(num_classes, 4, seed=seed)
        from sketchformer_tpu_torch.data.stroke3 import compute_deviation

        self.scale = compute_deviation(probe)

    def iter_pairs(self, split: str, epoch: int = 0):
        salt = {"train": 0, "valid": 7_777_777, "test": 15_555_555}[split]
        rng = np.random.default_rng(self.seed + salt + epoch)
        count = self.sketches_per_epoch if split == "train" else max(
            self.batch_size * 4, self.sketches_per_epoch // 8
        )
        for _ in range(count):
            c = int(rng.integers(self.num_classes))
            yield synthetic.generate_sketch(c, rng), c
