"""Per-request token streaming over the serving engine (counterpart of
the reference's ``serving/stream.py``).

``ServingEngine.submit()`` returns a :class:`ResponseStream`: an iterable
of token ids as the pool's decode step emits them, ending with a terminal
:class:`StreamStatus` (``stream.status`` / ``stream.result()``).  The
queue is bounded by the request's own budget (``max_new_tokens`` + the
terminal marker), so the producer never blocks.

Iteration follows the engine's drive mode: under the background step loop
(``engine.start()``) it blocks on the queue the loop feeds; in synchronous
``pump()`` mode it drives ``engine.pump(1)`` itself between reads.

Delivery is the ``stream.deliver`` fault seam.  The engine delivers a
token before it commits it, so a fault there leaves the token uncommitted
and recovery regenerates exactly that token: delivered-once and committed
stay equal.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Optional

from . import faults

__all__ = ["RequestState", "ResponseStream", "StreamStatus"]


class RequestState:
    """Request lifecycle: QUEUED -> PREFILLING -> DECODING -> terminal.

    ``PREEMPTED`` is a non-terminal detour off DECODING: the request was
    evicted mid-decode (its K/V spilled to the host tier) and will resume;
    its stream stays open and returns to DECODING at resume."""

    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    DECODING = "DECODING"
    PREEMPTED = "PREEMPTED"
    DONE = "DONE"
    CANCELLED = "CANCELLED"
    EXPIRED = "EXPIRED"
    FAILED = "FAILED"
    TERMINAL = frozenset({DONE, CANCELLED, EXPIRED, FAILED})


# the terminal record delivered once per request: finish_reason is the
# decode layer's eos/length for DONE, else the scheduler's
# cancelled/deadline/error; ttft_s is None when the request never
# produced a token
StreamStatus = collections.namedtuple(
    "StreamStatus",
    ["request_id", "state", "finish_reason", "tokens", "prompt_tokens",
     "new_tokens", "ttft_s", "total_s", "error"])

_TERMINAL = object()


class ResponseStream:
    """Iterable of one request's generated token ids + terminal status."""

    def __init__(self, engine, request_id, max_new_tokens: int):
        self._engine = engine
        self.request_id = request_id
        self._q: queue.Queue = queue.Queue(maxsize=int(max_new_tokens) + 1)
        self._done = threading.Event()
        self._status: Optional[StreamStatus] = None

    # -- engine side -----------------------------------------------------
    def _put_token(self, tok: int) -> None:
        faults.fire("stream.deliver")
        self._q.put_nowait(tok)

    def _finalize(self, status: StreamStatus) -> None:
        self._status = status
        self._q.put_nowait(_TERMINAL)
        self._done.set()

    # -- consumer side ---------------------------------------------------
    @property
    def status(self) -> Optional[StreamStatus]:
        """The terminal record, or None while the request is live."""
        return self._status

    @property
    def state(self) -> str:
        s = self._status
        if s is not None:
            return s.state
        return self._engine.request_state(self.request_id)

    def done(self) -> bool:
        return self._done.is_set()

    def __iter__(self):
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                if self._done.is_set():
                    return
                if self._engine.is_running():
                    item = self._q.get()  # the step loop feeds the queue
                else:
                    # synchronous mode: the consumer drives the engine
                    if not self._engine.pump(1) \
                            and not self._done.is_set():
                        return
                    continue
            if item is _TERMINAL:
                return
            yield item

    def result(self, timeout_s: Optional[float] = None
               ) -> Optional[StreamStatus]:
        """Wait for the terminal record, pumping the engine inline when it
        has no background loop; None when ``timeout_s`` passes first (in
        both drive modes)."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        if not self._done.is_set() and not self._engine.is_running():
            while not self._done.is_set() and (
                    deadline is None or time.monotonic() < deadline):
                if not self._engine.pump(1):
                    break
        self._done.wait(None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
        return self._status
