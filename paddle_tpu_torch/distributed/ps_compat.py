"""Parameter-server-era data plumbing kept API-compatible (a copy of the
reference's ``distributed/ps_compat.py``).

Reference parity: ``python/paddle/distributed/fleet/data_generator/
data_generator.py`` (MultiSlotDataGenerator:283), ``fleet/dataset/``
(InMemoryDataset/QueueDataset over the C++ MultiSlotDataFeed,
``framework/data_feed.cc``), and the sparse-table entry configs
(``CountFilterEntry``/``ProbabilityEntry``, ``distributed/entry_attr.h``).

The parameter server's serving half (brpc tables) is not ported; dense
training on the card replaces it.  What survives here is the data path: the slot-file format stays readable
and the datasets stream (slot → ndarray batch) dicts straight into the
ordinary training loop, instead of the C++ blocking-queue feed."""
from __future__ import annotations

import os
import random as _random
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.errors import InvalidArgumentError

__all__ = [
    "DataGenerator", "MultiSlotDataGenerator", "MultiSlotStringDataGenerator",
    "InMemoryDataset", "QueueDataset", "CountFilterEntry", "ProbabilityEntry",
]


class DataGenerator:
    """data_generator.py DataGenerator parity: user overrides generate_sample
    (and optionally generate_batch); run_from_stdin/run_from_memory emit the
    MultiSlot text format."""

    def __init__(self):
        self.batch_size_ = 32

    def set_batch(self, batch_size: int):
        self.batch_size_ = batch_size

    def generate_sample(self, line):  # pragma: no cover - interface
        raise NotImplementedError(
            "subclass DataGenerator and implement generate_sample")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s

        return local_iter

    def _gen_str(self, line) -> str:
        raise NotImplementedError

    # -- drivers --------------------------------------------------------
    def run_from_memory(self):
        samples = []
        for fn in [self.generate_sample(None)]:
            for sample in fn():
                samples.append(sample)
        for batch in [samples[i:i + self.batch_size_]
                      for i in range(0, len(samples), self.batch_size_)]:
            for sample in self.generate_batch(batch)():
                print(self._gen_str(sample), end="")

    def run_from_stdin(self):
        import sys

        for line in sys.stdin:
            fn = self.generate_sample(line)
            for sample in fn():
                print(self._gen_str(sample), end="")


class MultiSlotDataGenerator(DataGenerator):
    """Emits ``<len> <feasign...>`` per slot (MultiSlotDataFeed format)."""

    def _gen_str(self, line) -> str:
        if not isinstance(line, (list, tuple)):
            raise InvalidArgumentError(
                "sample must be [(name, [feasign, ...]), ...]")
        parts = []
        for _name, feasigns in line:
            parts.append(str(len(feasigns)))
            parts.extend(str(f) for f in feasigns)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    def _gen_str(self, line) -> str:
        parts = []
        for _name, feasigns in line:
            parts.append(str(len(feasigns)))
            parts.extend(str(f) for f in feasigns)
        return " ".join(parts) + "\n"


def _parse_slot_line(line: str, slots: Sequence[str], dtypes: Dict[str, str]):
    toks = line.split()
    out = {}
    i = 0
    for slot in slots:
        if i >= len(toks):
            raise InvalidArgumentError(
                "slot line ended early for slot %r" % slot)
        n = int(toks[i])
        i += 1
        vals = toks[i:i + n]
        i += n
        dt = dtypes.get(slot, "int64")
        out[slot] = np.asarray(vals, dtype=dt)
    return out


class _SlotDatasetBase:
    """Shared config surface of InMemoryDataset/QueueDataset."""

    def __init__(self):
        self._slots: List[str] = []
        self._dtypes: Dict[str, str] = {}
        self._batch_size = 1
        self._thread_num = 1
        self._filelist: List[str] = []
        self._pipe_command = None

    # reference config surface ------------------------------------------
    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command=None, input_type=0, fs_name="", fs_ugi="",
             **kwargs):
        self._batch_size = batch_size
        self._thread_num = thread_num
        if pipe_command is not None:
            self._pipe_command = pipe_command
        if use_var:
            self.set_use_var(use_var)
        return self

    def set_use_var(self, use_var):
        # replaces (not appends): repeat configuration must not duplicate
        # slots, which would desynchronize the slot-line parser
        self._slots = []
        self._dtypes = {}
        for v in use_var:
            name = getattr(v, "name", str(v))
            self._slots.append(name)
            dt = getattr(v, "dtype", "int64")
            self._dtypes[name] = np.dtype(dt).name \
                if not isinstance(dt, str) else dt

    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_thread(self, thread_num: int):
        self._thread_num = thread_num

    def set_filelist(self, filelist: Sequence[str]):
        for f in filelist:
            if not os.path.exists(f):
                raise InvalidArgumentError("dataset file %r not found" % f)
        self._filelist = list(filelist)

    def set_pipe_command(self, cmd: str):
        self._pipe_command = cmd

    def _iter_lines(self) -> Iterator[str]:
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line

    def _batches_from(self, lines) -> Iterator[Dict[str, np.ndarray]]:
        batch: List[Dict[str, np.ndarray]] = []
        for line in lines:
            batch.append(_parse_slot_line(line, self._slots, self._dtypes))
            if len(batch) == self._batch_size:
                yield self._collate(batch)
                batch = []
        if batch:
            yield self._collate(batch)

    @staticmethod
    def _collate(samples: List[Dict[str, np.ndarray]]):
        out = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            width = max(v.shape[0] for v in vals)
            arr = np.zeros((len(vals), width), vals[0].dtype)
            for i, v in enumerate(vals):
                arr[i, :v.shape[0]] = v
            out[k] = arr
        return out


class QueueDataset(_SlotDatasetBase):
    """fleet/dataset QueueDataset parity: streaming iteration over the
    slot files (the C++ blocking-queue feed becomes a generator)."""

    def __iter__(self):
        return self._batches_from(self._iter_lines())


class InMemoryDataset(_SlotDatasetBase):
    """fleet/dataset InMemoryDataset parity: load, shuffle, iterate."""

    def __init__(self):
        super().__init__()
        self._lines: List[str] = []

    def load_into_memory(self):
        self._lines = list(self._iter_lines())

    def local_shuffle(self, seed: Optional[int] = None):
        rng = _random.Random(seed)
        rng.shuffle(self._lines)

    def global_shuffle(self, fleet=None, thread_num: int = 12,
                       seed: Optional[int] = None):
        # single-controller: global == local
        self.local_shuffle(seed)

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._lines)

    def release_memory(self):
        self._lines = []

    def __iter__(self):
        if not self._lines:
            raise InvalidArgumentError(
                "call load_into_memory() before iterating InMemoryDataset")
        return self._batches_from(iter(self._lines))


class CountFilterEntry:
    """entry_attr.h CountFilterEntry parity: admit a sparse feature after
    it has been seen ``count`` times (config object consumed by sparse
    embedding setups)."""

    def __init__(self, count: int):
        if count < 1:
            raise InvalidArgumentError("count must be >= 1")
        self.count = count

    def _to_attr(self):
        return "count_filter_entry:%d" % self.count


class ProbabilityEntry:
    """entry_attr.h ProbabilityEntry parity: admit with probability p."""

    def __init__(self, probability: float):
        if not 0 < probability <= 1:
            raise InvalidArgumentError("probability must be in (0, 1]")
        self.probability = probability

    def _to_attr(self):
        return "probability_entry:%s" % self.probability
