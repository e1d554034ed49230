"""Legacy reader-decorator API (``paddle.reader``; a copy of the
reference's ``reader/__init__.py``).

Composable generator transforms over *reader creators*: zero-arg
callables returning an iterable of samples.  This is the fluid-era data
API (paddle's ``python/paddle/reader/decorator.py:52-640``); the modern
path is ``paddle_tpu_torch.io.DataLoader``, which adds worker processes
and staging on the card.  These decorators are host-side pure Python and
feed the same numpy samples.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from itertools import zip_longest

__all__ = [
    "cache", "map_readers", "shuffle", "chain", "compose", "buffered",
    "firstn", "xmap_readers", "multiprocess_reader", "ComposeNotAligned",
]


class ComposeNotAligned(ValueError):
    """Raised by :func:`compose` when input readers have unequal length."""


class _RaisedInWorker:
    """Queue envelope carrying a worker thread's exception to the consumer."""

    def __init__(self, error):
        self.error = error


def cache(reader):
    """Cache the first COMPLETE pass in memory; later passes replay it.

    Each running pass fills its own local buffer and commits only on
    completion, so an abandoned pass (early break, firstn) or two
    interleaved iterations (the same cached reader zipped with itself)
    can never memoize duplicated or dropped samples.
    Reference: ``reader/decorator.py:52``.
    """
    memory = []
    filled = []

    def cached():
        if filled:
            yield from memory
            return
        local = []
        for item in reader():
            local.append(item)
            yield item
        if not filled:  # first COMPLETE pass wins
            memory[:] = local
            filled.append(True)

    return cached


def map_readers(func, *readers):
    """Apply ``func`` element-wise across the zipped outputs of ``readers``.

    Reference: ``reader/decorator.py:92``.
    """

    def mapped():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return mapped


def shuffle(reader, buf_size):
    """Locally shuffle samples within a sliding buffer of ``buf_size``.

    Reference: ``reader/decorator.py:134``.
    """

    def shuffled():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    """Concatenate readers back to back.

    Reference: ``reader/decorator.py:183``.
    """

    def chained():
        yield from itertools.chain(*[r() for r in readers])

    return chained


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: ``(1, 2), 3 -> (1, 2, 3)``.

    ``check_alignment=True`` (default) raises :class:`ComposeNotAligned`
    when the readers have different lengths; ``False`` truncates to the
    shortest. Reference: ``reader/decorator.py:248``.
    """
    check_alignment = kwargs.pop("check_alignment", True)
    if kwargs:
        raise TypeError("compose() got unexpected kwargs %s" % sorted(kwargs))

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        its = [r() for r in readers]
        if check_alignment:
            for outputs in zip_longest(*its):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned.")
                yield sum((as_tuple(o) for o in outputs), ())
        else:
            for outputs in zip(*its):
                yield sum((as_tuple(o) for o in outputs), ())

    return composed


def buffered(reader, size):
    """Read ahead into a bounded buffer on a background thread.

    Reference: ``reader/decorator.py:308`` (the reference's C++
    buffered_reader analog for this legacy API; the DataLoader's
    prefetch supersedes it on the modern path).
    """

    def buffered_reader():
        q = queue.Queue(maxsize=size)
        end = object()

        def fill():
            # a reader failure is forwarded and re-raised in the consumer
            # — NOT swallowed into a silently truncated epoch
            try:
                for item in reader():
                    q.put(item)
                q.put(end)
            except BaseException as e:  # noqa: BLE001
                q.put(_RaisedInWorker(e))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, _RaisedInWorker):
                raise item.error
            yield item

    return buffered_reader


def firstn(reader, n):
    """Limit the reader to its first ``n`` samples.

    Reference: ``reader/decorator.py:367``.
    """

    def firstn_reader():
        yield from itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Apply ``mapper`` over ``reader`` with ``process_num`` worker threads.

    ``order=True`` preserves input order (workers tag samples with their
    index and a reorder stage releases them sequentially).
    Reference: ``reader/decorator.py:412``.
    """

    def xreader():
        in_q = queue.Queue(maxsize=buffer_size)
        out_q = queue.Queue(maxsize=buffer_size)
        end = object()

        def feed():
            # end markers go out even when the source reader raises, or
            # every worker (and the consumer) would block forever; the
            # exception itself is forwarded and re-raised in the consumer
            try:
                for i, item in enumerate(reader()):
                    in_q.put((i, item))
            except BaseException as e:  # noqa: BLE001
                out_q.put(_RaisedInWorker(e))
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            try:
                while True:
                    got = in_q.get()
                    if got is end:
                        return
                    i, item = got
                    out_q.put((i, mapper(item)))
            except BaseException as e:  # noqa: BLE001
                out_q.put(_RaisedInWorker(e))
            finally:
                out_q.put(end)

        threads = [threading.Thread(target=feed, daemon=True)]
        threads += [threading.Thread(target=work, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        pending, nxt = {}, 0
        while finished < process_num:
            got = out_q.get()
            if got is end:
                finished += 1
                continue
            if isinstance(got, _RaisedInWorker):
                raise got.error
            i, mapped = got
            if order:
                pending[i] = mapped
                while nxt in pending:
                    yield pending.pop(nxt)
                    nxt += 1
            else:
                yield mapped
        for i in sorted(pending):
            yield pending[i]

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers, each driven from its own process.

    The reference forks one OS process per reader and merges via a pipe
    or queue (``reader/decorator.py:505``). Here each reader runs on its
    own *thread* feeding one bounded queue: the heavy lifting in this
    framework's data path (decode/augment) is numpy releasing the GIL,
    and true multiprocess loading lives in ``paddle_tpu_torch.io.DataLoader``
    (shared-memory workers), which this legacy shim intentionally does
    not duplicate. Semantics (interleaved, unordered merge; all readers
    exhausted) match the reference.
    """
    if not readers:
        raise ValueError("multiprocess_reader: need at least one reader")

    def merged():
        q = queue.Queue(maxsize=queue_size)
        end = object()

        def drive(r):
            # forward a failed reader's exception instead of silently
            # dropping its share of the data
            try:
                for item in r():
                    q.put(item)
                q.put(end)
            except BaseException as e:  # noqa: BLE001
                q.put(_RaisedInWorker(e))

        for r in readers:
            threading.Thread(target=drive, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if item is end:
                finished += 1
                continue
            if isinstance(item, _RaisedInWorker):
                raise item.error
            yield item

    return merged
