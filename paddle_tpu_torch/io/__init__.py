"""Datasets, samplers and the ``DataLoader`` (counterpart of the
reference's ``io``): batches come out as tensors on the loader's device
(None: the card)."""
from .dataloader import (DataLoader, WorkerInfo,  # noqa: F401
                         default_collate_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, IterableDataset, Subset,
                      TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)

__all__ = [
    "DataLoader", "default_collate_fn", "Dataset", "IterableDataset",
    "TensorDataset", "ComposeDataset", "ChainDataset", "ConcatDataset",
    "Subset", "random_split", "Sampler", "SequenceSampler", "RandomSampler",
    "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "get_worker_info", "WorkerInfo",
]
