"""The serving engine: request lifecycle over the continuous-batching pool
(counterpart of the reference's ``serving/engine.py``, its core).

A scheduling tick is one ``pool.step()``; ``pump(n)`` runs ticks inline
on the calling thread.  Admission is bounded: past ``max_queue`` waiting
requests ``submit`` raises the typed, retryable :class:`QueueFullError`.
``priority``, ``tenant`` and ``deadline`` order admission in the pool.
Cancellation frees the slot and its paged blocks mid-generation.
``preempt(request_id)`` spills a decoding request to the host tier; it
resumes by itself when the pool next has room for it.  TTFT is observed
by the pool's ``on_token`` hook at the real first-token moment.

Pool knobs, chunked prefill (``prefill_chunk_tokens``), prefix sharing
(``prefix_sharing``) and the tenant cap (``tenant_slot_cap``) among them,
pass through to :class:`~paddle_tpu_torch.inference.GenerationPool`.

Not ported yet: the background step loop, deadline expiry and shedding,
the automatic preemption victim and the degradation ladder, the journal
and restore, recovery from a failed step, SLOs, metrics, logs and tracing,
the supervisor and the fleet.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..core.errors import InvalidArgumentError, NotFoundError, \
    UnavailableError
from ..inference.generation import GenerationPool
from .stream import RequestState, ResponseStream, StreamStatus

__all__ = ["ServingEngine", "QueueFullError", "PRIORITY_CLASSES"]

# named priority classes; priorities are plain ints underneath (higher
# admits first)
PRIORITY_CLASSES = {"low": -1, "normal": 0, "high": 1}


def _normalize_priority(priority) -> int:
    if isinstance(priority, str):
        if priority not in PRIORITY_CLASSES:
            raise InvalidArgumentError(
                "unknown priority class %r; named classes are %s, or pass "
                "an int (higher admits first)"
                % (priority, sorted(PRIORITY_CLASSES)))
        return PRIORITY_CLASSES[priority]
    if isinstance(priority, bool) or not isinstance(priority,
                                                    (int, np.integer)):
        raise InvalidArgumentError(
            "priority must be an int or one of %s, got %r"
            % (sorted(PRIORITY_CLASSES), priority))
    return int(priority)


class QueueFullError(UnavailableError):
    """Admission rejected: the wait queue is at ``max_queue`` depth.
    Retryable -- the caller backs off and resubmits."""


class _Record:
    """Engine-side per-request state (the pool keeps only slot state)."""

    __slots__ = ("rid", "stream", "state", "prompt_len", "max_new",
                 "submit_t", "first_t", "tokens", "priority", "tenant",
                 "preempts")

    def __init__(self, rid, stream, prompt_len: int, max_new: int,
                 submit_t: float, priority: int = 0, tenant=None):
        self.rid = rid
        self.stream = stream
        self.state = RequestState.QUEUED
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.submit_t = submit_t
        self.first_t = None
        self.tokens = []
        self.priority = priority
        self.tenant = tenant
        self.preempts = 0


class ServingEngine:
    """Request scheduler with streaming over
    :class:`~paddle_tpu_torch.inference.GenerationPool`.

    Pool knobs (``slots``, ``buckets``, ``cache_layout``, ``block_size``,
    ``num_blocks``, ``cache_dtype``, ``eos_id``, ``prefill_chunk_tokens``,
    ``prefix_sharing``, ``tenant_slot_cap``, sampling defaults) pass
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
        self._pool.on_resume = self._on_resume

    # -- admission -------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int, request_id=None,
               priority=0, tenant=None, deadline=None, temperature=None,
               top_k=None, top_p=None, seed=None) -> ResponseStream:
        """Admit one request; returns its :class:`ResponseStream`.

        ``priority`` (an int, or a name in ``PRIORITY_CLASSES``; higher
        admits first), ``tenant`` (the key of the pool's
        ``tenant_slot_cap``) and ``deadline`` (a number on the caller's
        clock, only compared: earlier admits first within a priority) are
        scheduling metadata for the pool.  Raises :class:`QueueFullError`
        past ``max_queue`` waiting requests, and the pool's typed errors
        for invalid prompts, budgets or duplicate ids."""
        priority = _normalize_priority(priority)
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
                                    request_id=request_id, priority=priority,
                                    tenant=tenant, deadline=deadline,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p, seed=seed)
            stream = ResponseStream(self, rid, int(max_new_tokens))
            self._live[rid] = _Record(rid, stream, int(ids.shape[0]),
                                      int(max_new_tokens), now,
                                      priority=priority, tenant=tenant)
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

    def _on_resume(self, rid, info):
        """A preempted request's K/V were restored and its slot
        re-activated (fires inside the pool's refill)."""
        rec = self._live.get(rid)
        if rec is not None:
            rec.state = RequestState.DECODING

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
        """Abort a live request (queued, prefilling, decoding or
        preempted): its slot, blocks and spilled copies are freed and its
        stream ends ``CANCELLED`` with the tokens emitted so far.  False
        if the id is not live."""
        with self._lock:
            rec = self._live.pop(request_id, None)
            if rec is None:
                return False
            self._pool.cancel(request_id)
            self._finalize(rec, RequestState.CANCELLED, "cancelled")
            return True

    def preempt(self, request_id):
        """Evict one decoding request into the host spill tier
        (``GenerationPool.preempt``); it resumes byte-identically when
        the pool next has room for it, and its state is ``PREEMPTED``
        meanwhile.  Returns the request id.  ``NotFoundError`` for an id
        that is not live or not decoding.  The automatic victim choice
        (``request_id=None``) is not ported yet."""
        if request_id is None:
            raise InvalidArgumentError(
                "preempt needs a request_id: the automatic victim choice "
                "is not ported yet")
        with self._lock:
            rec = self._live.get(request_id)
            if rec is None:
                raise NotFoundError(
                    "request_id %r is not live on this engine"
                    % (request_id,))
            self._pool.preempt(rec.rid)
            rec.state = RequestState.PREEMPTED
            rec.preempts += 1
            return rec.rid

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

    def prefix_stats(self) -> dict:
        """Prefix-sharing and chunked-prefill accounting
        (``GenerationPool.prefix_stats``)."""
        return self._pool.prefix_stats()

    def resident_prefix_digest(self, since_epoch=None):
        """The chain-hash keys of the resident prefix blocks
        (``GenerationPool.prefix_digest``); None when sharing is off."""
        with self._lock:
            return self._pool.prefix_digest(since_epoch)

    def reset_prefix_stats(self) -> None:
        """Zero the pool's cumulative prefix and chunk counters."""
        with self._lock:
            self._pool.reset_prefix_stats()

    def spill_stats(self) -> dict:
        """Spill-tier accounting (``GenerationPool.spill_stats``)."""
        return self._pool.spill_stats()

    def compile_counts(self) -> dict:
        """The pool's step keys (``GenerationPool.compile_counts``)."""
        return self._pool.compile_counts()

    def cost_version(self) -> int:
        """The pool's total step keys (``GenerationPool.cost_version``)."""
        return self._pool.cost_version()

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
