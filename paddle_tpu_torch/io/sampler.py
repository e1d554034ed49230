"""Samplers (counterpart of the reference's ``io/sampler.py``):
``Sampler``, ``SequenceSampler``, ``RandomSampler``,
``WeightedRandomSampler``, ``BatchSampler`` and
``DistributedBatchSampler``.

Orders are drawn with numpy's ``RandomState`` as in the reference, so a
seed or a ``RandomState`` gives the reference's order index for index.
Without one, ``RandomSampler`` seeds a ``RandomState`` from torch's CPU
generator under ``FLAGS_deterministic`` (so ``seed()`` reproduces the
data order), and from the OS otherwise.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..core.errors import InvalidArgumentError
from ..core.flags import flag
from .dataset import host_seed

__all__ = [
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler",
]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


def _as_rng(generator) -> Optional[np.random.RandomState]:
    if isinstance(generator, np.random.RandomState):
        return generator
    if isinstance(generator, int):
        return np.random.RandomState(generator)
    return None


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False,
                 num_samples: Optional[int] = None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        if not replacement and num_samples is not None \
                and num_samples > len(data_source):
            raise InvalidArgumentError(
                "num_samples %d > dataset size %d without replacement"
                % (num_samples, len(data_source)))

    @property
    def num_samples(self) -> int:
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def _rng(self) -> np.random.RandomState:
        rng = _as_rng(self.generator)
        if rng is not None:
            return rng
        if flag("FLAGS_deterministic"):
            return np.random.RandomState(host_seed())
        return np.random.RandomState()

    def __iter__(self):
        rng = self._rng()
        n = len(self.data_source)
        if self.replacement:
            yield from rng.randint(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement: bool = True, generator=None):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise InvalidArgumentError("weights must be non-negative")
        self.num_samples = int(num_samples)
        self.replacement = replacement
        self.generator = generator
        if not replacement and num_samples > len(self.weights):
            raise InvalidArgumentError(
                "num_samples %d > #weights %d without replacement"
                % (num_samples, len(self.weights)))

    def __iter__(self):
        rng = _as_rng(self.generator) or np.random.RandomState()
        p = self.weights / self.weights.sum()
        idx = rng.choice(len(self.weights), size=self.num_samples,
                         replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler`` (or a sequential
    or random sampler over ``dataset``)."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        super().__init__(dataset)
        if (dataset is None) == (sampler is None):
            raise InvalidArgumentError(
                "BatchSampler needs exactly one of dataset= or sampler=")
        if sampler is not None:
            self.sampler = sampler
        else:
            self.sampler = (RandomSampler(dataset) if shuffle
                            else SequenceSampler(dataset))
        if batch_size <= 0:
            raise InvalidArgumentError("batch_size must be positive")
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world() -> tuple:
    """(rank, world size) from ``torch.distributed``, or (0, 1) where it
    is not initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """This rank's share of the indices (every ``num_replicas``-th from
    ``rank``, the tail padded by wrapping unless ``drop_last``), in
    batches; shuffled by ``seed + epoch`` (``set_epoch``)."""

    def __init__(self, dataset, batch_size: int,
                 num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        world_rank, world_size = _world()
        self.num_replicas = (num_replicas if num_replicas is not None
                             else world_size)
        self.rank = rank if rank is not None else world_rank
        if not (0 <= self.rank < self.num_replicas):
            raise InvalidArgumentError(
                "rank %d out of range for %d replicas"
                % (self.rank, self.num_replicas))
        super().__init__(dataset=dataset, shuffle=shuffle,
                         batch_size=batch_size, drop_last=drop_last)
        self.seed = seed
        self.epoch = 0
        n = len(dataset)
        if drop_last:
            self.num_samples = n // self.num_replicas
        else:
            self.num_samples = (n + self.num_replicas - 1) \
                // self.num_replicas
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self):
        n = len(self.data_source)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last and len(indices) < self.total_size:
            indices += indices[: self.total_size - len(indices)]
        indices = indices[: self.total_size]
        shard = indices[self.rank::self.num_replicas]
        batch: List[int] = []
        for idx in shard:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
