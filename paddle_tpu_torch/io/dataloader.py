"""``DataLoader`` with forked worker processes and a prefetch stage that
puts each batch on the card (counterpart of the reference's
``io/dataloader.py``).

Two stages, as the reference's worker -> queue -> buffered reader:

- ``num_workers`` forked worker processes index the dataset, run its
  transforms and collate, and ship each numpy batch through POSIX shared
  memory.  They are forked after CUDA may be initialised, so they run
  numpy only: no torch op, no CUDA call (the default collate stacks
  numpy arrays).  Results are reordered to the sampler's order.  An
  array too large for the free space of ``/dev/shm`` goes through the
  queue pickled instead.
- the parent's prefetch thread (``FLAGS_prefetch_depth`` batches ahead)
  stages each batch on the loader's device.  On the card a batch's
  arrays are copied into pinned host buffers and from there to the card
  with ``non_blocking=True`` on a side stream the staging thread owns;
  an event recorded after the copies goes with the batch.  The consumer
  makes its current stream wait on that event and calls
  ``record_stream`` on each tensor, so the caching allocator never hands
  a batch's memory out while the consumer's stream may still read it.
  A pinned buffer is refilled only after the event of its last copy has
  completed.  On the CPU a batch is ``torch.from_numpy`` of its arrays.

``device`` (or the reference's ``places``) says where batches go: None
is ``cuda``, which raises without a card; ``"cpu"`` is asked for
explicitly (the tests do).  ``num_workers=0`` loads in the calling
thread, and on the card still copies through the pinned ring and the
side stream.  An ``IterableDataset`` with workers gives each worker a
round-robin slice, so batches across workers are not in the serial
order (the reference's contract).
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing as mp
import os
import queue
import threading
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core import flags as _flags
from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "WorkerInfo"]


def default_collate_fn(batch: Sequence):
    """Stack samples into batch arrays (numpy only: it runs in the
    workers)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([s[i] for s in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if torch.is_tensor(sample):
        return np.stack([np.asarray(s) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, str):
        return list(batch)
    return np.asarray(batch)


def _map_arrays(x, fn):
    if isinstance(x, (tuple, list)):
        return tuple(_map_arrays(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map_arrays(v, fn) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return fn(x)
    return x


def _tensors(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif torch.is_tensor(x):
        yield x


class _Staged:
    """A batch on the card and the event its copies end in."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device):
        self.batch = batch
        self.event = event
        self.device = device


class _Stager:
    """Numpy batches to tensors on ``device``: ``torch.from_numpy`` on the
    CPU; on the card through a ring of pinned buffers a (shape, dtype)
    and one side stream, made by the thread that stages."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self._ring_size = depth + 2
        self._rings: dict = {}
        self._stream = None

    def stage(self, batch, copy: bool = False):
        """``copy``: the arrays are views the caller frees afterwards (a
        worker's shared segments), so the CPU route copies them."""
        if self.device.type != "cuda":
            return _map_arrays(
                batch, lambda a: torch.from_numpy(
                    np.array(a) if copy or not a.flags.writeable else a))
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        used: List[list] = []
        with torch.cuda.stream(self._stream):
            out = _map_arrays(batch, lambda a: self._upload(a, used))
            event = torch.cuda.Event()
            event.record(self._stream)
        for slot in used:
            slot[1] = event
        return _Staged(out, event, self.device)

    def _upload(self, a: np.ndarray, used: List[list]) -> torch.Tensor:
        ring = self._rings.setdefault((a.shape, a.dtype.str),
                                      collections.deque())
        if len(ring) < self._ring_size:
            slot = [torch.from_numpy(np.empty(a.shape, a.dtype)
                                     ).pin_memory(), None]
        else:
            slot = ring.popleft()
            if slot[1] is not None:
                slot[1].synchronize()  # its last copy has left the buffer
        ring.append(slot)
        slot[0].numpy()[...] = a
        used.append(slot)
        return slot[0].to(self.device, non_blocking=True)


def _deliver(item):
    """In the consuming thread: wait for a staged batch's copies on the
    current stream and tie its tensors to that stream."""
    if not isinstance(item, _Staged):
        return item
    cur = torch.cuda.current_stream(item.device)
    cur.wait_event(item.event)
    for t in _tensors(item.batch):
        t.record_stream(cur)
    return item.batch


# ---------------------------------------------------------------------------
# Worker processes
# ---------------------------------------------------------------------------

_SHM_MIN_BYTES = 1 << 14
_SHM_DIR = "/dev/shm"


def _shm_fits(nbytes: int) -> bool:
    """Whether ``/dev/shm`` has room for a segment of ``nbytes`` (twice
    over: other batches are in flight).  A segment past its free space
    would kill the worker with SIGBUS on the first write."""
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        return False
    return st.f_bavail * st.f_frsize >= 2 * nbytes


def _shm_encode(obj, segments: List):
    """Replace the large arrays of a collated batch by shared-memory
    references (an array with no room in ``/dev/shm`` goes through the
    queue pickled)."""
    from multiprocessing import shared_memory

    if isinstance(obj, (tuple, list)):
        return tuple(_shm_encode(v, segments) for v in obj)
    if isinstance(obj, dict):
        return {k: _shm_encode(v, segments) for k, v in obj.items()}
    if isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_MIN_BYTES \
            and _shm_fits(obj.nbytes):
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)[...] = obj
        segments.append(shm)
        return ("__shm__", shm.name, obj.shape, str(obj.dtype))
    return obj


def _shm_decode(obj, opened: List):
    """Views of the shared segments (the caller copies out, then closes
    and unlinks ``opened``)."""
    from multiprocessing import shared_memory

    if isinstance(obj, tuple) and len(obj) == 4 \
            and isinstance(obj[0], str) and obj[0] == "__shm__":
        shm = shared_memory.SharedMemory(name=obj[1])
        opened.append(shm)
        return np.ndarray(obj[2], obj[3], buffer=shm.buf)
    if isinstance(obj, (tuple, list)):
        return tuple(_shm_decode(v, opened) for v in obj)
    if isinstance(obj, dict):
        return {k: _shm_decode(v, opened) for k, v in obj.items()}
    return obj


def _release(opened: List) -> None:
    for s in opened:
        s.close()
        try:
            s.unlink()
        except FileNotFoundError:
            pass


def _put_batch(result_q, batch_idx, out, use_shm: bool):
    if use_shm:
        segments: List = []
        enc = _shm_encode(out, segments)
        result_q.put((batch_idx, "ok", enc))
        for s in segments:  # the parent unlinks; the worker only closes
            s.close()
    else:
        result_q.put((batch_idx, "ok", out))


_worker_info = None


class WorkerInfo:
    """``get_worker_info()``'s record: the worker's id, the number of
    workers and the dataset."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return "WorkerInfo(id=%d, num_workers=%d)" % (self.id,
                                                      self.num_workers)


def get_worker_info():
    """Inside a loader worker: its :class:`WorkerInfo`; None in the main
    process."""
    return _worker_info


def _worker_loop(dataset, collate_fn, task_q, result_q, use_shm: bool,
                 worker_id: int, worker_init_fn, iterable_cfg,
                 num_workers: int = 1):
    """A worker's body.  Map-style: take ``(batch_idx, indices)`` tasks
    and put collated batches keyed by ``batch_idx``.  Iterable: stream
    this worker's slice ``(start, step, batch_size, drop_last)``."""
    import traceback

    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    try:
        try:
            if worker_init_fn is not None:
                worker_init_fn(worker_id)
        except Exception:
            # -1: a failure before any task; the parent raises it at once
            result_q.put((-1, "error", traceback.format_exc()))
            return
        if iterable_cfg is not None:
            start, step, bs, drop_last = iterable_cfg
            try:
                batch: List = []
                for sample in itertools.islice(iter(dataset), start, None,
                                               step):
                    if task_q.qsize() and task_q.get_nowait() is None:
                        return  # shut down early
                    batch.append(sample)
                    if len(batch) == bs:
                        _put_batch(result_q, worker_id, collate_fn(batch),
                                   use_shm)
                        batch = []
                if batch and not drop_last:
                    _put_batch(result_q, worker_id, collate_fn(batch),
                               use_shm)
            except Exception:
                result_q.put((worker_id, "error", traceback.format_exc()))
            result_q.put((worker_id, "__end__", None))
            return
        while True:
            task = task_q.get()
            if task is None:
                return
            batch_idx, indices = task
            try:
                _put_batch(result_q, batch_idx,
                           collate_fn([dataset[i] for i in indices]),
                           use_shm)
            except Exception:
                result_q.put((batch_idx, "error", traceback.format_exc()))
    except KeyboardInterrupt:  # the parent's teardown
        pass


class _MultiprocessIterator:
    """Batches from forked workers in the sampler's order (an iterable
    dataset's in arrival order); at most ``num_workers * depth`` batches
    in flight.  Yields ``(batch, segments)``: the caller copies the batch
    out of its shared segments and then :func:`_release`\\ s them."""

    _EMPTY = queue.Empty  # bound now: the module global may be gone in __del__

    def __init__(self, loader, depth: int):
        ctx = mp.get_context("fork")  # workers inherit the dataset
        if loader.use_shared_memory:
            # one tracker for all: a worker forked before the parent's
            # tracker runs starts its own, which would report the
            # segments the parent unlinks as leaked
            from multiprocessing import resource_tracker

            resource_tracker.ensure_running()
        self._use_shm = loader.use_shared_memory
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._next_out = 0
        self._next_in = 0
        self._buffer: dict = {}
        self._shutdown_done = False
        self._iterable = loader._iterable_mode
        self._tasks = iter(()) if self._iterable \
            else iter(enumerate(loader.batch_sampler))
        self._exhausted = False
        self._n_workers = loader.num_workers
        self._live_ends = set(range(self._n_workers))
        self._workers = []
        for wid in range(self._n_workers):
            iter_cfg = None
            if self._iterable:
                iter_cfg = (wid, self._n_workers, loader.batch_size or 1,
                            loader.drop_last)
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, loader.collate_fn, self._task_q,
                      self._result_q, self._use_shm, wid,
                      loader.worker_init_fn, iter_cfg, self._n_workers),
                daemon=True)
            w.start()
            self._workers.append(w)
        if not self._iterable:
            for _ in range(self._n_workers * max(1, depth)):
                self._dispatch_one()

    def _dispatch_one(self):
        if self._exhausted:
            return
        try:
            self._task_q.put(next(self._tasks))
            self._next_in += 1
        except StopIteration:
            self._exhausted = True

    def __iter__(self):
        return self

    def _get(self):
        """One result, raising when the workers died without one."""
        while True:
            try:
                return self._result_q.get(timeout=5.0)
            except queue.Empty:
                if self._iterable:
                    alive = [w for wid, w in enumerate(self._workers)
                             if wid in self._live_ends and w.is_alive()]
                    dead = not alive
                else:
                    dead = any(not w.is_alive() for w in self._workers)
                if dead:
                    self.shutdown()
                    raise RuntimeError(
                        "DataLoader worker(s) %s died unexpectedly"
                        % [w.pid for w in self._workers
                           if not w.is_alive()])

    def _decode(self, payload):
        opened: List = []
        if self._use_shm:
            payload = _shm_decode(payload, opened)
        return payload, opened

    def __next__(self):
        if self._iterable:
            while True:
                if not self._live_ends:
                    self.shutdown()
                    raise StopIteration
                wid, status, payload = self._get()
                if status == "__end__":
                    self._live_ends.discard(wid)
                    continue
                if status == "error":
                    self.shutdown()
                    raise RuntimeError(
                        "DataLoader worker failed:\n%s" % payload)
                return self._decode(payload)
        if self._next_out >= self._next_in and self._exhausted:
            self.shutdown()
            raise StopIteration
        while self._next_out not in self._buffer:
            idx, status, payload = self._get()
            if idx == -1:
                self.shutdown()
                raise RuntimeError(
                    "DataLoader worker failed during init:\n%s" % payload)
            self._buffer[idx] = (status, payload)
        status, payload = self._buffer.pop(self._next_out)
        self._next_out += 1
        self._dispatch_one()
        if status == "error":
            self.shutdown()
            raise RuntimeError("DataLoader worker failed:\n%s" % payload)
        return self._decode(payload)

    def shutdown(self):
        if self._shutdown_done:
            return
        self._shutdown_done = True
        for _ in self._workers:
            try:
                self._task_q.put_nowait(None)
            except Exception:  # pragma: no cover
                pass
        for w in self._workers:
            w.join(timeout=2)
            if w.is_alive():
                w.terminate()
                w.join(timeout=2)

        def free(payload):
            if self._use_shm:
                opened: List = []
                _shm_decode(payload, opened)
                _release(opened)

        # in-flight segments: the reorder buffer's and the queue's
        for status, payload in self._buffer.values():
            if status == "ok":
                free(payload)
        self._buffer.clear()
        try:
            while True:
                _, status, payload = self._result_q.get_nowait()
                if status == "ok":
                    free(payload)
        except self._EMPTY:
            pass

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # pragma: no cover
            pass


class _PrefetchIterator:
    """A thread running ``produce`` at most ``depth`` items ahead; its
    error is raised in the consumer.  ``on_stop`` runs when the consumer
    lets go early."""

    _SENTINEL = object()
    _EMPTY = queue.Empty
    _FULL = queue.Full

    def __init__(self, produce, depth: int, on_stop=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[BaseException] = None
        self._stop = threading.Event()
        self._on_stop = on_stop

        def run():
            try:
                for item in produce():
                    if not self._put(item):
                        return
            except BaseException as e:  # handed to the consumer
                self._exc = e
            self._put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except self._FULL:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def shutdown(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except self._EMPTY:
            pass
        self._thread.join(timeout=5)
        if self._on_stop is not None:
            self._on_stop()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass  # interpreter teardown


class _LoaderIter:
    """What ``iter(loader)`` returns: the staged batches, delivered to
    the consumer's stream."""

    def __init__(self, source, stop=None):
        self._source = source
        self._stop = stop

    def __iter__(self):
        return self

    def __next__(self):
        return _deliver(next(self._source))

    def __del__(self):
        if self._stop is not None:
            try:
                self._stop()
            except Exception:
                pass


def _resolve_place(places, device) -> torch.device:
    where = device if device is not None else places
    if isinstance(where, (list, tuple)):
        where = where[0] if where else None
    if isinstance(where, str):
        where = where.lower()
        if where == "gpu" or where.startswith("gpu:"):
            where = "cuda" + where[3:]
    return resolve_device(where)


class DataLoader:
    """Batches of ``dataset`` as tensors on ``device`` (the reference's
    ``DataLoader`` arguments; ``places``/``device``: None is the card).

    ``num_workers=0`` loads synchronously; above 0, that many forked
    worker processes feed a prefetch thread (``FLAGS_prefetch_depth``
    batches, or ``prefetch_factor``) that stages batches on the device.
    ``use_shared_memory=False`` pickles batches through the queue.
    ``return_list`` is accepted (batches are always list-style)."""

    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True,
                 batch_sampler: Optional[BatchSampler] = None,
                 batch_size: Optional[int] = 1, shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: Optional[int] = None,
                 use_shared_memory: bool = True, timeout: int = 0,
                 worker_init_fn: Optional[Callable] = None, device=None):
        self.dataset = dataset
        self.device = _resolve_place(places, device)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = bool(use_shared_memory)
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if prefetch_factor is None:
            prefetch_factor = _flags.flag("FLAGS_prefetch_depth")
        self.prefetch_factor = int(prefetch_factor)
        if self._iterable_mode:
            if batch_sampler is not None:
                raise InvalidArgumentError(
                    "batch_sampler is invalid for IterableDataset")
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
            self.drop_last = batch_sampler.drop_last
        else:
            if batch_size is None:
                raise InvalidArgumentError(
                    "batch_size or batch_sampler required")
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise InvalidArgumentError(
                "DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    def _serial_batches(self):
        if self._iterable_mode:
            if self.worker_init_fn is not None:
                self.worker_init_fn(0)
            batch: List[Any] = []
            for sample in self.dataset:
                batch.append(sample)
                if self.batch_size is not None \
                        and len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.worker_init_fn is not None:
            self.worker_init_fn(0)
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        stager = _Stager(self.device, self.prefetch_factor)
        if self.num_workers <= 0:
            return _LoaderIter(stager.stage(b)
                               for b in self._serial_batches())
        workers = _MultiprocessIterator(self, self.prefetch_factor)

        def produce():
            for batch, opened in workers:
                try:
                    yield stager.stage(batch, copy=bool(opened))
                finally:
                    _release(opened)

        if not self.use_buffer_reader:
            return _LoaderIter(produce(), workers.shutdown)
        prefetch = _PrefetchIterator(produce, self.prefetch_factor,
                                     on_stop=workers.shutdown)
        return _LoaderIter(prefetch, prefetch.shutdown)

    def __call__(self):
        return self.__iter__()
