"""Datasets (counterpart of the reference's ``io/dataset.py``):
``Dataset``, ``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``ConcatDataset``, ``Subset`` and ``random_split``.

Samples are numpy: ``TensorDataset`` holds its inputs as arrays (a torch
tensor is copied to the host once), so a forked loader worker indexes it
without a torch op.
"""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np
import torch

from ..core.errors import InvalidArgumentError

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
]


def host_seed() -> int:
    """A seed drawn from torch's CPU generator, so ``seed()`` makes what
    it drives (a split, a shuffle) reproducible."""
    return int(torch.randint(0, 2 ** 31 - 1, ()).item())


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            "%s must implement __getitem__" % type(self).__name__)

    def __len__(self):
        raise NotImplementedError(
            "%s must implement __len__" % type(self).__name__)


class IterableDataset(Dataset):
    """Stream-style dataset."""

    def __iter__(self):
        raise NotImplementedError(
            "%s must implement __iter__" % type(self).__name__)

    def __getitem__(self, idx):
        raise InvalidArgumentError(
            "IterableDataset is not subscriptable; iterate it")

    def __len__(self):
        raise InvalidArgumentError(
            "IterableDataset has no len(); iterate it")


class TensorDataset(Dataset):
    """Zip of equally long arrays or tensors, indexed on the first axis."""

    def __init__(self, tensors: Sequence):
        arrays = [t.detach().cpu().numpy() if torch.is_tensor(t)
                  else np.asarray(t) for t in tensors]
        if not arrays:
            raise InvalidArgumentError(
                "TensorDataset needs at least one tensor")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise InvalidArgumentError(
                    "TensorDataset tensors must share dim 0: %d vs %d"
                    % (n, a.shape[0]))
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """The fields of several equally long datasets, zipped."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise InvalidArgumentError("ComposeDataset needs datasets")
        n = len(self.datasets[0])
        for d in self.datasets:
            if len(d) != n:
                raise InvalidArgumentError(
                    "ComposeDataset datasets must share length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out: List = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    """Iterable datasets one after another."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Map-style datasets one after another."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise InvalidArgumentError("ConcatDataset needs datasets")
        self.cumulative_sizes: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    """Disjoint random subsets of the given lengths.  ``generator``: a
    numpy ``RandomState`` or a seed (the reference's permutation, index
    for index); None draws the seed from torch's CPU generator."""
    total = sum(int(n) for n in lengths)
    if total != len(dataset):
        raise InvalidArgumentError(
            "random_split lengths sum %d != dataset length %d"
            % (total, len(dataset)))
    if generator is None:
        generator = np.random.RandomState(host_seed())
    elif isinstance(generator, int):
        generator = np.random.RandomState(generator)
    perm = generator.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + int(n)].tolist()))
        offset += int(n)
    return out
