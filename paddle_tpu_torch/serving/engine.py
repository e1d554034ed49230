"""The serving engine: request lifecycle over the continuous-batching pool
(counterpart of the reference's ``serving/engine.py``, its core).

A scheduling tick is one ``pool.step()``; ``pump(n)`` runs ticks inline
on the calling thread.  Admission is bounded: past ``max_queue`` waiting
requests ``submit`` raises the typed, retryable :class:`QueueFullError`.
Cancellation frees the slot and its paged blocks mid-generation.  TTFT is
observed by the pool's ``on_token`` hook at the real first-token moment.

Not ported yet: the background step loop, deadlines and shedding, the
journal and restore, recovery from a failed step, SLOs and the
degradation ladder, metrics, tracing, the supervisor and the fleet.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..core.errors import InvalidArgumentError, UnavailableError
from ..inference.generation import GenerationPool
from .stream import RequestState, ResponseStream, StreamStatus

__all__ = ["ServingEngine", "QueueFullError"]


class QueueFullError(UnavailableError):
    """Admission rejected: the wait queue is at ``max_queue`` depth.
    Retryable -- the caller backs off and resubmits."""


class _Record:
    """Engine-side per-request state (the pool keeps only slot state)."""

    __slots__ = ("rid", "stream", "state", "prompt_len", "max_new",
                 "submit_t", "first_t", "tokens")

    def __init__(self, rid, stream, prompt_len: int, max_new: int,
                 submit_t: float):
        self.rid = rid
        self.stream = stream
        self.state = RequestState.QUEUED
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.submit_t = submit_t
        self.first_t = None
        self.tokens = []


class ServingEngine:
    """Request scheduler with streaming over
    :class:`~paddle_tpu_torch.inference.GenerationPool`.

    Pool knobs (``slots``, ``buckets``, ``cache_layout``, ``block_size``,
    ``num_blocks``, ``cache_dtype``, ``eos_id``, sampling defaults) pass
    through ``**pool_kwargs``; ``device=None`` is ``cuda``; ``clock``
    injects a monotonic time source."""

    def __init__(self, model, max_len: int, slots: int = 4,
                 max_queue: int = 64, clock=None, device=None,
                 **pool_kwargs):
        if int(max_queue) < 1:
            raise InvalidArgumentError(
                "max_queue must be >= 1, got %r" % (max_queue,))
        self._pool = GenerationPool(model, max_len, slots=slots,
                                    device=device, **pool_kwargs)
        self.max_queue = int(max_queue)
        self._clock = clock if clock is not None else time.monotonic
        self._live: Dict[object, _Record] = {}
        self._lock = threading.RLock()
        self._pool.on_admit = self._on_admit
        self._pool.on_token = self._on_token
        self._pool.on_finish = self._on_finish

    # -- admission -------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int, request_id=None,
               temperature=None, top_k=None, top_p=None,
               seed=None) -> ResponseStream:
        """Admit one request; returns its :class:`ResponseStream`.  Raises
        :class:`QueueFullError` past ``max_queue`` waiting requests, and
        the pool's typed errors for invalid prompts, budgets or duplicate
        ids."""
        with self._lock:
            depth = self._pool.queue_depth
            if depth >= self.max_queue:
                raise QueueFullError(
                    "serving queue is full (%d waiting >= max_queue=%d); "
                    "back off and retry, or raise max_queue/slots"
                    % (depth, self.max_queue))
            ids = np.asarray(input_ids)
            now = self._clock()
            rid = self._pool.submit(ids, max_new_tokens,
                                    request_id=request_id,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p, seed=seed)
            stream = ResponseStream(self, rid, int(max_new_tokens))
            self._live[rid] = _Record(rid, stream, int(ids.shape[0]),
                                      int(max_new_tokens), now)
            return stream

    # -- pool hooks (fire inside pool.step, under the engine lock) -------
    def _on_admit(self, rid, slot, prompt_len):
        rec = self._live.get(rid)
        if rec is not None:
            rec.state = RequestState.PREFILLING

    def _on_token(self, rid, tok):
        rec = self._live.get(rid)
        if rec is None:
            return
        rec.stream._put_token(int(tok))
        if rec.first_t is None:
            rec.first_t = self._clock()
            rec.state = RequestState.DECODING
        rec.tokens.append(int(tok))

    def _on_finish(self, rid, tokens, reason):
        rec = self._live.pop(rid, None)
        if rec is None:
            return
        self._pool.collect(rid)  # frees the rid; tokens already streamed
        self._finalize(rec, RequestState.DONE, reason)

    def _finalize(self, rec: _Record, state: str, reason: str) -> None:
        now = self._clock()
        toks = np.asarray(rec.tokens, np.int32)
        rec.state = state
        rec.stream._finalize(StreamStatus(
            request_id=rec.rid, state=state, finish_reason=reason,
            tokens=toks, prompt_tokens=rec.prompt_len,
            new_tokens=int(toks.size),
            ttft_s=(None if rec.first_t is None
                    else rec.first_t - rec.submit_t),
            total_s=now - rec.submit_t, error=None))

    def cancel(self, request_id) -> bool:
        """Abort a live request: its slot and blocks are freed and its
        stream ends ``CANCELLED`` with the tokens emitted so far.  False if
        the id is not live."""
        with self._lock:
            rec = self._live.pop(request_id, None)
            if rec is None:
                return False
            self._pool.cancel(request_id)
            self._finalize(rec, RequestState.CANCELLED, "cancelled")
            return True

    # -- drive ------------------------------------------------------------
    def pump(self, steps: int = 1) -> bool:
        """Run up to ``steps`` ticks inline; True while live requests
        remain."""
        if int(steps) < 1:
            raise InvalidArgumentError(
                "pump needs steps >= 1, got %r" % (steps,))
        work = bool(self._live)
        for _ in range(int(steps)):
            with self._lock:
                if not self._live:
                    return False
                self._pool.step()
                work = bool(self._live)
            if not work:
                break
        return work

    # -- introspection ------------------------------------------------------
    def request_state(self, request_id) -> Optional[str]:
        """Lifecycle state of a live request; None if unknown/terminal."""
        with self._lock:
            rec = self._live.get(request_id)
            return rec.state if rec is not None else None

    def cache_stats(self) -> dict:
        """Live KV accounting (``GenerationPool.cache_stats``)."""
        return self._pool.cache_stats()

    @property
    def pool(self) -> GenerationPool:
        """The pool this engine schedules over."""
        return self._pool

    @property
    def queue_depth(self) -> int:
        return self._pool.queue_depth

    @property
    def live_requests(self) -> int:
        return len(self._live)
