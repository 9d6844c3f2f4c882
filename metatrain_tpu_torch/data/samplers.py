"""Batch samplers and the data loader.

Counterpart of ``metatrain_tpu/data/samplers.py`` (a copy: the same seeds,
shuffles and batches): fixed-size batching, greedy atom-count packing with
a deterministic fixed-seed pack + per-epoch batch-order shuffle,
rank-strided assignment for data parallelism, and oversized structure
dropping. :class:`PrefetchingLoader` collates in one background thread,
ahead of the training step, in the sampler's order.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Sequence

import numpy as np

from .collate import Batch, CollateFn
from .dataset import Dataset


logger = logging.getLogger(__name__)


class BatchSampler:
    """Fixed-size index batches, optionally sharded across ranks.

    With ``num_replicas > 1`` every rank gets the same number of batches
    (trailing remainder dropped), matching the deterministic sharded
    sampling the reference gets from ``DistributedSampler``.
    """

    def __init__(
        self,
        n_samples: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        num_replicas: int = 1,
        rank: int = 0,
    ):
        self.n_samples = n_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[np.ndarray]:
        order = np.arange(self.n_samples)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(self.n_samples)
        if self.drop_last:
            n_full = (self.n_samples // self.batch_size) * self.batch_size
            order = order[:n_full]
        return [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]

    def __iter__(self) -> Iterator[np.ndarray]:
        batches = self._batches()
        if self.num_replicas > 1:
            n_even = (len(batches) // self.num_replicas) * self.num_replicas
            batches = batches[self.rank : n_even : self.num_replicas]
        return iter(batches)

    def __len__(self) -> int:
        n = self.n_samples
        if self.drop_last:
            n_batches = n // self.batch_size
        else:
            n_batches = (n + self.batch_size - 1) // self.batch_size
        if self.num_replicas > 1:
            n_batches //= self.num_replicas
        return n_batches


class MaxAtomBatchSampler:
    """Greedy atom-count-bounded batch packing.

    Structures are packed (in fixed-seed shuffled order) into batches whose
    total atom count stays below ``max_atoms``; packing is computed once,
    and only the batch *order* is reshuffled each epoch, keyed on the epoch
    (reference ``utils/data/samplers.py:50-165,324-354``). Oversized
    structures are dropped with a warning; batches under ``min_atoms`` are
    discarded.
    """

    def __init__(
        self,
        atom_counts: Sequence[int],
        max_atoms: int,
        min_atoms: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        num_replicas: int = 1,
        rank: int = 0,
    ):
        self.atom_counts = np.asarray(atom_counts, dtype=np.int64)
        self.max_atoms = max_atoms
        self.min_atoms = min_atoms
        self.shuffle = shuffle
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self._packed = self._pack()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _pack(self) -> List[np.ndarray]:
        n = len(self.atom_counts)
        order = np.arange(n)
        if self.shuffle:
            # packing always uses the fixed seed so batch composition is
            # stable across epochs (only batch order varies)
            order = np.random.default_rng(self.seed).permutation(n)

        oversized = self.atom_counts[order] > self.max_atoms
        if oversized.any():
            logger.warning(
                "%d structures exceed max_atoms_per_batch=%d and are dropped",
                int(oversized.sum()),
                self.max_atoms,
            )
            order = order[~oversized]

        batches: List[List[int]] = []
        current: List[int] = []
        current_atoms = 0
        for idx in order:
            count = int(self.atom_counts[idx])
            if current and current_atoms + count > self.max_atoms:
                batches.append(current)
                current, current_atoms = [], 0
            current.append(int(idx))
            current_atoms += count
        if current:
            batches.append(current)

        kept = [
            np.asarray(b, dtype=np.int64)
            for b in batches
            if self.atom_counts[b].sum() >= self.min_atoms
        ]
        return kept

    def __iter__(self) -> Iterator[np.ndarray]:
        batches = list(self._packed)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            batches = [batches[i] for i in rng.permutation(len(batches))]
        if self.num_replicas > 1:
            n_even = (len(batches) // self.num_replicas) * self.num_replicas
            batches = batches[self.rank : n_even : self.num_replicas]
        return iter(batches)

    def __len__(self) -> int:
        n = len(self._packed)
        return n // self.num_replicas if self.num_replicas > 1 else n


class DataLoader:
    """Iterates a dataset through a sampler and collate function."""

    def __init__(self, dataset: Dataset, sampler, collate_fn: CollateFn):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self) -> Iterator[Batch]:
        for indices in self.sampler:
            samples = [self.dataset[int(i)] for i in indices]
            yield self.collate_fn(samples)

    def __len__(self) -> int:
        return len(self.sampler)


class PrefetchingLoader:
    """Background-thread prefetch: overlaps host-side collation with
    device execution (the role DataLoader worker processes play in the
    reference, ``utils/data/dataset.py:1145-1205``, without fork)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error_holder = []

        def worker():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as err:  # propagate to the consumer
                error_holder.append(err)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
        if error_holder:
            raise error_holder[0]


class CombinedDataLoader:
    """Interleave batches from several loaders in shuffled order
    (reference ``utils/data/combine_dataloaders.py``)."""

    def __init__(self, loaders: Sequence[DataLoader], shuffle: bool = True, seed: int = 0):
        self.loaders = list(loaders)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __iter__(self) -> Iterator[Batch]:
        sources = []
        for li, loader in enumerate(self.loaders):
            sources.extend([li] * len(loader))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            sources = [sources[i] for i in rng.permutation(len(sources))]
        iterators = [iter(loader) for loader in self.loaders]
        for li in sources:
            yield next(iterators[li])

    def __len__(self) -> int:
        return sum(len(loader) for loader in self.loaders)
