"""The serving engine: request lifecycle over the continuous-batching pool
(counterpart of the reference's ``serving/engine.py``).

``inference.GenerationPool`` is the device-facing half of serving: slots,
paged blocks, one captured decode step per tick.  This module is the half
a server talks to: the request LIFECYCLE (``QUEUED -> PREFILLING ->
DECODING -> {DONE, CANCELLED, EXPIRED, FAILED}``, with the ``PREEMPTED``
detour), admission control, deadlines, token streaming, recovery and the
serving metrics.

- **One tick, two drive modes.**  A tick is the deadline sweep, the
  degradation ladder, one ``pool.step()`` and a gauge refresh.
  ``pump(n)`` runs ticks inline on the calling thread (deterministic: what
  the tests use); ``start()`` runs the same ``_tick`` in an owned
  background thread, which waits on an event only when a tick reports no
  work.
- **Fail-fast admission.**  Past ``max_queue`` waiting requests
  ``submit`` raises :class:`QueueFullError`; a ``deadline_s`` the observed
  tick rate cannot meet is shed with :class:`DeadlineUnattainableError`;
  below-floor priorities are shed with :class:`AdmissionTightenedError`
  while the ladder holds its deepest rung.  All three are retryable.
- **Deadlines and cancellation free real resources**: the slot and its
  paged blocks go back to the allocator mid-generation.
- **Request-level recovery.**  A failed ``pool.step()`` does not fail
  every live request: prompt + committed tokens determine greedy decode
  state, so ``_recover`` resets the pool (same step keys and captured
  graphs, the cache zeroed in place) and resubmits each victim as prompt
  + committed tokens.  A recovery never captures a new graph.  Retries are
  bounded per request (``max_retries``) and typed
  (``faults.classify_error``); permanent errors and exhausted budgets end
  FAILED with the retry count and the root error.
- **Preemption and the ladder.**  ``preempt()`` spills a decoding request
  to the host tier (automatic victim: the lowest priority, youngest
  first).  With ``degrade=True`` the SLO tracker's burn alert steps a
  ladder down (1 preempt low priority for waiting higher priority, 2
  reduce spec-K to 1 on a speculative pool, restored to the operator's
  setting when the rung disengages, 3 tighten admission) and back up when
  it clears.  Degraded is healthy.
- **Speculative decoding.**  ``draft_model=`` (and ``spec_k=``) puts the
  engine on :class:`~paddle_tpu_torch.inference.speculative.SpeculativePool`:
  the lifecycle is unchanged (a tick commits 1 to ``spec_k + 1`` tokens
  per slot) and the engine gains the ``serving_acceptance_rate`` gauge.
- **Crash durability.**  With ``journal_path=`` every admission and each
  tick's committed-token batch land in an append-only CRC-framed
  write-ahead journal (``serving/journal.py``) whose header carries the
  pool's config fingerprint; ``checkpoint()`` compacts it to one snapshot
  record and ``restore(path)`` lets a fresh process (or a second engine
  with the same weights) adopt it: victims spilled to the disk tier are
  re-parked from their PTKV files, every other survivor is resubmitted as
  prompt + committed, so every greedy survivor finishes byte-identically
  with no new capture on warmed steps.  While replaying the engine is
  RESTORING: ``health()`` is unhealthy with a Retry-After hint and
  submits are deferred, never dropped.  Under write faults the journal
  falls behind (records stay pending), never wrong.
- **Observability.**  Every tick stamps a lock-free heartbeat
  (``supervisor.EngineHealth``) that ``health()`` reads without the
  engine lock; metrics come from the real path; with a tracer installed
  each tick is a numbered span and the lifecycle lands in the flight
  recorder; structured log lines go through ``serving/log.py``.

Threads and the card.  One reentrant lock serializes every pool access:
``submit``, ``cancel``, ``preempt``, the stats passthroughs and the tick
all hold it, so the only thread that touches the device while a tick runs
(a decode step's first capture included) is the one running the tick, and
a CUDA graph capture never sees another thread's CUDA call.  The lock is
handed over in arrival order, so a submitter waits at most for the tick
in progress.  ``health()`` and the metrics registry read host state only.
The loop thread sets the pool's device as its current device before its
first tick.

Roles and hand-offs.  ``role="fused"`` (the default) is the single
engine above.  ``role="prefill"`` runs admission and chunked prefill only:
a request whose prompt is resident and whose first token is committed
parks, and the export sweep at the tick's edge writes its K/V to a PTKV
transfer file and fires ``on_handoff(rid, info)`` before finalizing the
request ``HANDED_OFF`` here.  ``role="decode"`` admits those hand-offs
through :meth:`ServingEngine.adopt_transfer`; a fused engine behind a
fleet admits live migrations through :meth:`ServingEngine.adopt_migration`
and gives them up through :meth:`ServingEngine.migrate_out`.  Both
adoptions are one body: the journal first, then the pool's ``adopt_spill``
(the request re-parks in the spill tier and resumes with no re-prefill,
its K/V uploaded into the cache in place, so no captured graph moves),
with prompt + committed resubmit as the byte-identical fallback.

Cost attribution.  :meth:`ServingEngine.cost_report` is the pool's (step
keys counted once each by ``jit.aot``); the ``serving_step_flops``,
``serving_step_bytes_accessed`` and ``serving_hbm_reserved_bytes`` gauges
follow its ``derived`` block and are refreshed only when the pool's
``cost_version()`` moves.

Multi-LoRA.  ``submit(adapter=)`` picks a row of the model's LoRA bank
(``nn.lora``; 0 is the base model); the id rides the request's record
through recovery, migration, the journal and PTKV files.
:meth:`ServingEngine.load_adapter` / :meth:`~ServingEngine.unload_adapter`
hot-swap bank rows under the engine lock (in place: no capture), and
:meth:`~ServingEngine.has_adapter` is what the fleet's router places
adapter traffic by.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.errors import (InvalidArgumentError, NotFoundError,
                           PreconditionNotMetError, UnavailableError)
from ..inference.generation import (DuplicateRequestError, GenerationPool,
                                    _SamplingConfig)
from ..profiler import StepTimer
from . import faults, trace
from . import log as slog
from .journal import (FingerprintMismatchError, JournalWriteError,
                      JournalWriter, read_journal, replay)
from .metrics import MetricsRegistry
from .stream import RequestState, ResponseStream, StreamStatus
from .supervisor import EngineHealth

__all__ = ["ServingEngine", "QueueFullError", "DeadlineUnattainableError",
           "AdmissionTightenedError", "PRIORITY_CLASSES"]

# named priority classes; priorities are plain ints underneath (higher
# admits first, ties broken by deadline then arrival)
PRIORITY_CLASSES = {"low": -1, "normal": 0, "high": 1}


def _jsonable_rid(rid):
    """Request ids round-trip the journal as JSON values: ints and
    strings verbatim (numpy ints normalized); anything else is refused at
    the submit edge by ``_check_journal_rid``."""
    if isinstance(rid, np.integer):
        return int(rid)
    return rid


def _samp_json(cfg):
    """A resolved sampling config as its journal form, the 5-list
    ``[temperature, top_k, top_p, seed, draws]`` (None passes through)."""
    if cfg is None:
        return None
    return [float(cfg.temperature), int(cfg.top_k), float(cfg.top_p),
            int(cfg.seed), int(cfg.draws)]


def _samp_from_json(val):
    """Inverse of :func:`_samp_json`; a 4-list replays at draw 0."""
    if val is None:
        return None
    return _SamplingConfig(
        float(val[0]), int(val[1]), float(val[2]), int(val[3]),
        int(val[4]) if len(val) > 4 else 0)


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


class DeadlineUnattainableError(UnavailableError):
    """Admission rejected: given the live backlog and the observed tick
    rate, the request cannot finish inside its ``deadline_s``.  Retryable;
    ``retry_after_s`` estimates when the same deadline would be feasible
    (the HTTP front end maps it to 503 + Retry-After)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class AdmissionTightenedError(UnavailableError):
    """Admission rejected by the degradation ladder's tighten-admission
    rung: while the SLO burn alert holds the engine at level 3, submits
    below the priority floor are shed.  Retryable (503 + Retry-After)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class _FairRLock:
    """A reentrant lock handed to waiting threads in arrival order.

    The loop thread releases the engine lock at the end of a tick and
    takes it again at once; on the card a tick holds it through the
    step's token download.  CPython's locks are not FIFO, so the releasing
    thread, already running, usually wins the race against the waiter it
    just woke, and a submitter could wait for many ticks.  Here a thread
    that finds others queued queues behind them."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._owner = None
        self._count = 0
        self._queue = collections.deque()

    def acquire(self, blocking: bool = True) -> bool:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._count += 1
                return True
            if self._owner is None and not self._queue:
                self._owner, self._count = me, 1
                return True
            if not blocking:
                return False
            self._queue.append(me)
            while self._owner is not None or self._queue[0] != me:
                self._cond.wait()
            self._queue.popleft()
            self._owner, self._count = me, 1
            return True

    def release(self) -> None:
        with self._cond:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of an engine lock not held")
            self._count -= 1
            if self._count == 0:
                self._owner = None
                if self._queue:
                    self._cond.notify_all()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False


class _Record:
    """Engine-side per-request state (the pool keeps only slot state).
    ``prompt`` is kept because it is the recovery source: prompt +
    ``tokens`` (the committed output) determine greedy decode state."""

    __slots__ = ("rid", "stream", "state", "prompt", "prompt_len",
                 "max_new", "deadline_abs", "submit_t", "first_t",
                 "last_t", "tokens", "retries", "priority", "tenant",
                 "preempts", "preempted_at", "sampling", "adapter")

    def __init__(self, rid, stream, prompt, max_new, deadline_abs,
                 submit_t, priority=0, tenant=None, sampling=None,
                 adapter=0):
        self.rid = rid
        self.stream = stream
        self.state = RequestState.QUEUED
        self.prompt = prompt
        self.prompt_len = int(prompt.shape[0])
        self.max_new = max_new
        self.deadline_abs = deadline_abs
        self.submit_t = submit_t
        self.first_t = None
        self.last_t = None
        self.tokens = []
        self.retries = 0
        self.priority = priority
        self.tenant = tenant
        self.preempts = 0
        self.preempted_at = None
        # the resolved sampling config and the LoRA adapter id: every
        # resubmission continues the request's own stream on its adapter
        self.sampling = sampling
        self.adapter = adapter


class ServingEngine:
    """Request scheduler with streaming, deadlines, recovery and metrics
    over :class:`~paddle_tpu_torch.inference.GenerationPool`.

    Pool knobs (``buckets``, ``cache_layout``, ``block_size``,
    ``num_blocks``, ``cache_dtype``, ``eos_id``, ``prefill_chunk_tokens``,
    ``prefix_sharing``, ``tenant_slot_cap``, sampling defaults) pass
    through ``**pool_kwargs``; ``device=None`` is ``cuda``.  ``clock``
    injects a monotonic time source (deadline tests); ``metrics`` shares a
    registry; ``slo`` is an :class:`~.slo.SLOTracker`, required by
    ``degrade=True``.  ``draft_model`` (with ``spec_k``, default 4)
    serves through the speculative pool; ``journal_path`` (with
    ``journal_fsync`` ``"tick"``, ``"always"`` or ``"never"``) makes the
    engine crash-durable.  ``role`` is ``"fused"``, ``"prefill"`` or
    ``"decode"`` (module docstring): the tiers hand K/V off through the
    disk spill tier (``spill_tier="disk"``, ``spill_dir=`` shared by both),
    the prefill tier needs ``prefill_chunk_tokens`` and the decode tier
    refuses it, and neither takes a draft model."""

    def __init__(self, model, max_len: int, slots: int = 4,
                 max_queue: int = 64, clock=None,
                 metrics: Optional[MetricsRegistry] = None,
                 draft_model=None, spec_k: Optional[int] = None,
                 max_retries: int = 2, slo=None, degrade: bool = False,
                 degrade_max_level: int = 3,
                 degrade_dwell_ticks: int = 2,
                 degrade_clear_ticks: int = 3,
                 degrade_admit_floor=1,
                 journal_path: Optional[str] = None,
                 journal_fsync: str = "tick", role: str = "fused",
                 device=None, **pool_kwargs):
        if int(max_queue) < 1:
            raise InvalidArgumentError(
                "max_queue must be >= 1, got %r" % (max_queue,))
        if int(max_retries) < 0:
            raise InvalidArgumentError(
                "max_retries must be >= 0 (0 = never resubmit after a "
                "step failure), got %r" % (max_retries,))
        if role not in ("fused", "prefill", "decode"):
            raise InvalidArgumentError(
                "role must be 'fused', 'prefill', or 'decode', got %r"
                % (role,))
        if role != "fused":
            if draft_model is not None:
                raise InvalidArgumentError(
                    "disaggregated tiers run the plain pool: the "
                    "speculative pool's draft state does not cross the "
                    "K/V hand-off -- use role='fused' with draft_model")
            if pool_kwargs.get("spill_tier") != "disk":
                raise InvalidArgumentError(
                    "role=%r hands K/V off through the disk transfer "
                    "contract -- pass spill_tier='disk' and spill_dir= "
                    "(the directory both tiers share)" % (role,))
        if role == "prefill":
            if pool_kwargs.get("prefill_chunk_tokens") is None:
                raise InvalidArgumentError(
                    "role='prefill' needs prefill_chunk_tokens= (the "
                    "tier runs ONLY admission + chunked prefill)")
            pool_kwargs["prefill_only"] = True
        if role == "decode" \
                and pool_kwargs.get("prefill_chunk_tokens") is not None:
            # the decode tier never captures a chunk step: its fallback
            # re-prefill is the session's bucketed prefill
            raise InvalidArgumentError(
                "role='decode' must not set prefill_chunk_tokens: the "
                "decode tier adopts finished prefills and never runs the "
                "chunk step")
        self.role = str(role)
        if degrade and slo is None:
            raise InvalidArgumentError(
                "degrade=True needs an SLO tracker: the ladder steps on "
                "the multi-window burn alert -- pass "
                "slo=serving.slo.SLOTracker([...objectives...])")
        if degrade and not 1 <= int(degrade_max_level) <= 3:
            raise InvalidArgumentError(
                "degrade_max_level must be in [1, 3] (1 preempt, "
                "2 +reduce-spec-K, 3 +tighten-admission), got %r"
                % (degrade_max_level,))
        if degrade and (int(degrade_dwell_ticks) < 1
                        or int(degrade_clear_ticks) < 1):
            raise InvalidArgumentError(
                "degrade_dwell_ticks and degrade_clear_ticks must be "
                ">= 1 tick, got %r / %r"
                % (degrade_dwell_ticks, degrade_clear_ticks))
        if draft_model is not None:
            from ..inference.speculative import SpeculativePool

            self._pool = SpeculativePool(model, draft_model, max_len,
                                         spec_k=4 if spec_k is None
                                         else spec_k, slots=slots,
                                         device=device, **pool_kwargs)
        elif spec_k is not None:
            # spec_k without a draft would silently run un-speculated
            raise InvalidArgumentError(
                "spec_k=%r was given without draft_model: speculative "
                "decoding needs the draft -- pass draft_model= (spec_k "
                "then defaults to 4), or drop spec_k for a plain "
                "engine" % (spec_k,))
        else:
            self._pool = GenerationPool(model, max_len, slots=slots,
                                        device=device, **pool_kwargs)
        # the current CUDA device is per thread: the loop thread sets the
        # pool's card, resolved here (``cuda`` without an index is the
        # constructing thread's current card)
        dev = self._pool.device
        self._loop_device = None if dev.type != "cuda" else (
            dev.index if dev.index is not None
            else torch.cuda.current_device())
        self.max_queue = int(max_queue)
        self.max_retries = int(max_retries)
        self._clock = clock if clock is not None else time.monotonic
        self._started_at = self._clock()
        self._health = EngineHealth()
        self._slo = slo
        # the cost gauges refresh only when the pool's cost version moves
        self._cost_seen = 0
        # the ladder: level 0 is normal service; each alerting tick past
        # the dwell steps down a rung, each clear run of clear_ticks steps
        # back up.  ticks_since_change starts "infinite" so the first
        # alerting tick escalates at once
        self._degrade_on = bool(degrade)
        self._degrade_level = 0
        self._degrade_max = int(degrade_max_level)
        self._degrade_dwell = int(degrade_dwell_ticks)
        self._degrade_clear = int(degrade_clear_ticks)
        self._degrade_floor = _normalize_priority(degrade_admit_floor)
        self._degrade_ticks_since_change = 1 << 30
        self._degrade_clean_ticks = 0
        self._degrade_transitions = 0
        self._spec_k_full = getattr(self._pool, "spec_k", None)
        # the runtime spec-K the ladder found when it engaged the reduce
        # rung (None while disengaged): the rung restores the operator's
        # setting, not the construction-time ceiling
        self._spec_k_saved = None
        self._live: Dict[object, _Record] = {}
        # the write-ahead journal: admissions are durable before they can
        # commit tokens, token batches ride one commit record a tick,
        # terminals close them.  The writer validates an existing file's
        # fingerprint and truncates a torn tail
        self._journal = None if journal_path is None else JournalWriter(
            journal_path, self._pool.config_fingerprint(),
            fsync=journal_fsync)
        if self._journal is not None \
                and self._journal.max_int_rid is not None:
            # same-path restart: the adopted journal's auto ids are taken
            self._pool.advance_auto_rids(self._journal.max_int_rid + 1)
        # this tick's committed-token deltas and the record backlog a
        # failed append leaves behind
        self._jl_tick_toks: Dict[object, List[int]] = {}
        self._jl_pending: List[dict] = []
        # RESTORING: health() unhealthy with a Retry-After hint, submits
        # deferred (parked with a live stream, admitted when replay ends)
        self._restoring = False
        self._restore_retry_after_s = 1.0
        self._deferred_submits: List[tuple] = []
        # one reentrant lock serializes every pool access (see the module
        # docstring); uncontended in pump mode
        self._lock = _FairRLock()
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._timer = StepTimer()
        self._tokens_total = 0
        # tracing state: the last tracer a tick saw (or start_trace
        # installed) stays referenced for export after stop_trace(); the
        # watermarks feed the drop counter and the compile events
        self._tracer: Optional[trace.Tracer] = None
        self._trace_dropped_seen = 0
        self._compile_seen: Optional[dict] = None

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_submitted = m.counter(
            "serving_requests_submitted_total", "requests admitted")
        self._c_done = m.counter(
            "serving_requests_completed_total",
            "requests finished (eos/length)")
        self._c_cancelled = m.counter(
            "serving_requests_cancelled_total",
            "requests cancelled by callers")
        self._c_expired = m.counter(
            "serving_requests_expired_total",
            "requests past their deadline")
        self._c_failed = m.counter(
            "serving_requests_failed_total",
            "requests failed by step errors")
        self._c_rejected = m.counter(
            "serving_admission_rejected_total",
            "submits refused with QueueFullError")
        self._c_shed = m.counter(
            "serving_requests_shed_total",
            "deadline submits shed as unattainable at admission")
        self._c_recovered = m.counter(
            "serving_requests_recovered_total",
            "requests resubmitted token-identically after a step failure")
        self._c_recoveries = m.counter(
            "serving_recoveries_total",
            "pool reset + resubmit recovery events")
        self._c_restarts = m.counter(
            "serving_engine_restarts_total",
            "dead background loops restarted by the supervisor")
        self._c_stalled = m.counter(
            "serving_ticks_stalled_total",
            "ticks that exceeded the supervisor's stall timeout")
        self._c_tokens = m.counter(
            "serving_tokens_emitted_total", "tokens streamed to callers")
        self._c_preempts = m.counter(
            "serving_preemptions_total",
            "active requests evicted mid-decode (K/V spilled to the "
            "host-RAM tier)")
        self._c_resumes = m.counter(
            "serving_resumes_total",
            "preempted requests resumed (K/V re-mapped or uploaded back "
            "from host RAM)")
        self._c_spill_bytes = m.counter(
            "serving_spill_bytes_total",
            "K/V bytes copied device-to-host at preemption (int8 caches "
            "count int8 K/V + fp32 scales)")
        self._c_tightened = m.counter(
            "serving_admission_tightened_total",
            "submits shed below the priority floor while the degradation "
            "ladder holds tighten-admission")
        self._g_preempted = m.gauge(
            "serving_preempted_requests",
            "live requests currently parked in the spill tier")
        paged = self._pool.cache_layout == "paged"
        self._g_spilled_blocks = m.gauge(
            "serving_spilled_blocks",
            "paged KV blocks in the reclaimable spilled tier "
            "(device-resident copies of preempted requests' K/V)") \
            if paged else None
        self._g_degrade = m.gauge(
            "serving_degrade_level",
            "degradation ladder level (0 normal, 1 preempt, "
            "2 +reduce-spec-K, 3 +tighten-admission)") \
            if self._degrade_on else None
        self._c_journal_records = m.counter(
            "serving_journal_records_total",
            "records appended to the write-ahead request journal")
        self._c_journal_bytes = m.counter(
            "serving_journal_bytes_total",
            "framed bytes appended to the request journal")
        self._c_journal_errors = m.counter(
            "serving_journal_errors_total",
            "journal append/sync failures caught (each is retried or "
            "left pending -- the journal falls behind, never lies)")
        self._c_journal_truncated = m.counter(
            "serving_journal_truncated_records_total",
            "records dropped by torn-tail truncation during replay")
        self._c_checkpoints = m.counter(
            "serving_checkpoints_total",
            "checkpoint snapshots written (journal compactions)")
        self._c_replayed = m.counter(
            "serving_journal_replayed_total",
            "live requests reconstructed from a journal by restore()")
        self._c_restores = m.counter(
            "serving_restores_total",
            "journal restore operations completed on this engine")
        self._c_trace_dropped = m.counter(
            "serving_trace_events_dropped_total",
            "flight-recorder ring overflow: trace events evicted before "
            "export")
        self._g_queue = m.gauge(
            "serving_queue_depth", "requests waiting for a slot")
        self._h_queue = m.histogram(
            "serving_queue_depth_per_step", "queue depth sampled each tick",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._g_active = m.gauge(
            "serving_active_slots", "slots currently decoding")
        self._g_occupancy = m.gauge(
            "serving_slot_occupancy", "active slots / total slots")
        self._g_kv_bytes = m.gauge(
            "serving_kv_reachable_bytes",
            "KV bytes a decode step can read right now (cache_stats)")
        self._g_kv_resident = m.gauge(
            "serving_kv_resident_bytes",
            "KV cache bytes resident on device (whole pool allocation, "
            "dtype-aware: int8 caches count int8 K/V + fp32 scales)")
        self._g_kv_free = m.gauge(
            "serving_kv_free_blocks", "paged allocator free blocks") \
            if paged else None
        # sharded serving: these gauges exist only over a DecodeMesh.  The
        # per-shard resident bytes are the per-device headroom figure (a
        # mesh-total gauge would overstate it by dp)
        sharded = self._pool.mesh is not None
        self._g_mesh_devices = m.gauge(
            "serving_mesh_devices",
            "shards the decode mesh spans (dp * mp)") if sharded else None
        self._g_kv_resident_shard = m.gauge(
            "serving_kv_resident_bytes_per_shard",
            "KV cache bytes resident in ONE dp shard's partition "
            "(mesh total / dp)") if sharded else None
        self._g_kv_reachable_shard = m.gauge(
            "serving_kv_reachable_bytes_max_shard",
            "largest per-dp-shard reachable KV bytes right now (the most "
            "loaded shard's occupancy)") if sharded else None
        sharing = self._pool.prefix_sharing
        self._g_prefix_hit = m.gauge(
            "serving_prefix_hit_rate",
            "admissions that matched a resident prefix / admissions "
            "(cumulative, prefix sharing)") if sharing else None
        self._g_prefix_shared = m.gauge(
            "serving_prefix_blocks_shared",
            "KV blocks currently referenced beyond their first owner "
            "(live memory the prefix index is saving)") \
            if sharing else None
        self._c_chunks = m.counter(
            "serving_prefill_chunks_total",
            "fixed-shape prompt chunks dispatched (chunked prefill: at "
            "most prefill_chunk_tokens of prompt work per tick)") \
            if self._pool.prefill_chunk_tokens is not None else None
        self._chunks_seen = 0
        self._g_accept = m.gauge(
            "serving_acceptance_rate",
            "accepted draft tokens / drafted (speculative pool)") \
            if hasattr(self._pool, "acceptance_stats") else None
        self._g_tps = m.gauge(
            "serving_tokens_per_sec",
            "tokens emitted / cumulative step time (StepTimer)")
        self._g_step = m.gauge(
            "serving_step_time_s", "mean batched decode step wall time")
        self._h_ttft = m.histogram(
            "serving_ttft_seconds", "submit-to-first-token latency")
        self._h_itl = m.histogram(
            "serving_inter_token_seconds", "gap between consecutive tokens")
        # what one batched step asks of the card (cost_report's derived
        # block): refreshed only when a step key is counted or captured
        self._g_step_flops = m.gauge(
            "serving_step_flops",
            "FLOPs of one batched decode step/round: unfused aten ops "
            "plus the hand-written kernels' counts (jit.aot)")
        self._g_step_bytes = m.gauge(
            "serving_step_bytes_accessed",
            "bytes read and written by one batched decode step/round "
            "(unfused aten ops plus the kernels' counts, jit.aot)")
        self._g_hbm_reserved = m.gauge(
            "serving_hbm_reserved_bytes",
            "card memory the decode step holds: arguments + outputs - "
            "in-place aliases + the captured graph's pool (set once the "
            "step is captured on the card)")
        if self._slo is not None:
            self._slo.bind_metrics(m)

        self._pool.on_admit = self._on_admit
        self._pool.on_token = self._on_token
        self._pool.on_finish = self._on_finish
        self._pool.on_resume = self._on_resume
        # the prefill tier's hand-off: the pool hook queues rids whose
        # prefill completed this tick, the export sweep at the tick's edge
        # writes each transfer file and fires on_handoff(rid, info)
        self._export_ready: List = []
        self.on_handoff = None
        self._c_handed_off = m.counter(
            "serving_requests_handed_off_total",
            "prefill-complete requests exported over the K/V transfer "
            "contract and handed to a decode tier") \
            if role == "prefill" else None
        if role == "prefill":
            self._pool.on_prefill_done = self._on_prefill_done
        # a torn tail the writer truncated when it re-opened an existing
        # file is surfaced now that the metric and log planes exist
        if self._journal is not None and self._journal.truncated_bytes:
            self._c_journal_truncated.inc(self._journal.truncated_records)
            trace.instant(
                "journal.truncated",
                dropped_records=self._journal.truncated_records,
                dropped_bytes=self._journal.truncated_bytes)
            slog.emit(
                "journal.truncated", path=self._journal.path,
                dropped_records=self._journal.truncated_records,
                dropped_bytes=self._journal.truncated_bytes, at="open")

    # -- admission -------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int, request_id=None,
               deadline_s: Optional[float] = None, priority=0,
               tenant=None, temperature=None, top_k=None, top_p=None,
               seed=None, adapter: int = 0) -> ResponseStream:
        """Admit one request; returns its :class:`ResponseStream`.

        ``priority`` (an int, or a name in ``PRIORITY_CLASSES``: higher
        admits first, preempts last, and survives admission tightening)
        and ``tenant`` (the key of the pool's ``tenant_slot_cap``) order
        admission.  ``temperature``/``top_k``/``top_p``/``seed`` are this
        request's sampling config (None fields take the pool's defaults),
        resolved once here so every resubmission continues the same
        stream; ``adapter`` is its LoRA adapter id (0 = the base model).
        ``deadline_s`` is a wall-clock budget from now: queued or
        decoding, the request expires (slot and blocks freed) at the first
        tick past it.

        Raises :class:`QueueFullError`, :class:`DeadlineUnattainableError`
        and :class:`AdmissionTightenedError` (all retryable), the pool's
        typed errors for invalid prompts, budgets or duplicate ids, and
        ``PreconditionNotMetError`` once draining.  A journaled engine
        makes the admission durable first and rejects it with the
        retryable ``JournalWriteError`` when it cannot.  While RESTORING
        the request is deferred: the stream is live, and an automatic
        ``request_id`` is None until the admission after the replay
        assigns it."""
        priority = _normalize_priority(priority)
        if deadline_s is not None and not (float(deadline_s) > 0):
            # `not (x > 0)`: a NaN deadline fails it too
            raise InvalidArgumentError(
                "deadline_s must be > 0 (or None for no deadline), "
                "got %r" % (deadline_s,))
        with self._lock:
            if self._draining:
                raise PreconditionNotMetError(
                    "engine is draining/shut down: admissions are "
                    "stopped (drain()/shutdown() was called)")
            samp = self._pool._resolve_sampling(temperature, top_k, top_p,
                                                seed)
            adapter = self._pool._check_adapter(adapter)
            if self._restoring:
                return self._defer_submit(input_ids, max_new_tokens,
                                          request_id, deadline_s, priority,
                                          tenant, samp, adapter)
            if self._degrade_level >= 3 and priority < self._degrade_floor:
                self._c_tightened.inc()
                trace.instant("req.shed", rid=request_id,
                              priority=priority, tightened=True)
                slog.emit("req.shed", rid=request_id, priority=priority,
                          tightened=True,
                          degrade_level=self._degrade_level)
                raise AdmissionTightenedError(
                    "admission tightened: the degradation ladder is at "
                    "level %d (SLO burn alert active) and priority %d is "
                    "below the floor %d; retry when the alert clears, or "
                    "submit at/above the floor"
                    % (self._degrade_level, priority, self._degrade_floor))
            depth = self._pool.queue_depth
            if depth >= self.max_queue:
                self._c_rejected.inc()
                raise QueueFullError(
                    "serving queue is full (%d waiting >= max_queue=%d); "
                    "back off and retry, or raise max_queue/slots"
                    % (depth, self.max_queue))
            ids = np.asarray(input_ids)
            if deadline_s is not None:
                est = self._deadline_estimate_s(
                    int(max_new_tokens),
                    int(ids.shape[0]) if ids.ndim else 0)
                if est is not None and est > float(deadline_s):
                    self._c_shed.inc()
                    retry = max(0.001, est - float(deadline_s))
                    trace.instant("shed", rid=request_id,
                                  deadline_s=float(deadline_s),
                                  estimate_s=est)
                    slog.emit("req.shed", rid=request_id,
                              deadline_s=float(deadline_s),
                              estimate_s=round(est, 6))
                    raise DeadlineUnattainableError(
                        "deadline_s=%.3g cannot be met: the live backlog "
                        "and observed tick rate put completion ~%.3gs "
                        "out; shed at admission (retryable) -- retry "
                        "after ~%.3gs, or relax the deadline"
                        % (float(deadline_s), est, retry),
                        retry_after_s=retry)
            now = self._clock()
            deadline_abs = None if deadline_s is None \
                else now + float(deadline_s)
            if self._journal is not None:
                self._check_journal_rid(request_id)
            rid = self._pool.submit(ids, max_new_tokens,
                                    request_id=request_id,
                                    priority=priority, tenant=tenant,
                                    deadline=deadline_abs, adapter=adapter,
                                    _sampling=samp)
            stream = ResponseStream(self, rid, int(max_new_tokens))
            self._live[rid] = _Record(
                rid, stream, ids.astype(np.int32), int(max_new_tokens),
                deadline_abs, now, priority=priority, tenant=tenant,
                sampling=samp, adapter=adapter)
            if self._journal is not None:
                # write-ahead: the admission is durable before the
                # request can commit a token, or it is rejected
                try:
                    self._journal_admit(rid, ids, max_new_tokens,
                                        deadline_s, priority, tenant,
                                        sampling=samp, adapter=adapter)
                except Exception as e:  # noqa: BLE001 - reject, typed
                    self._pool.cancel(rid)
                    self._live.pop(rid, None)
                    raise JournalWriteError(
                        "admission rejected: the request journal could "
                        "not record it (%s: %s); retry -- an admission "
                        "the journal cannot replay would be silently "
                        "non-durable" % (type(e).__name__,
                                         str(e)[:200])) from e
            self._c_submitted.inc()
            trace.instant("req.queued", rid=rid,
                          prompt_tokens=int(ids.shape[0]),
                          max_new_tokens=int(max_new_tokens),
                          deadline_s=deadline_s,
                          priority=priority or None, tenant=tenant)
            self._g_queue.set(self._pool.queue_depth)
        self._wake.set()
        return stream

    def _defer_submit(self, input_ids, max_new_tokens, request_id,
                      deadline_s, priority, tenant, samp,
                      adapter=0) -> ResponseStream:
        """Park a submit that arrived while RESTORING (the caller holds
        the lock).  The deferral has the wait queue's bound; a duplicate
        explicit id is refused now with the normal typed error.  The
        deadline is anchored at this submit, so the replay's wait counts
        against it."""
        if len(self._deferred_submits) >= self.max_queue:
            self._c_rejected.inc()
            raise QueueFullError(
                "restore in progress and the deferred-submit queue is full "
                "(%d waiting >= max_queue=%d); back off and retry after "
                "the restore" % (len(self._deferred_submits),
                                 self.max_queue))
        if request_id is not None and (
                request_id in self._live or any(
                    e[0] == request_id for e in self._deferred_submits)):
            raise DuplicateRequestError(
                "request_id %r is already live or deferred on this "
                "restoring engine" % (request_id,))
        ids = np.asarray(input_ids)
        if self._journal is not None:
            self._check_journal_rid(request_id)
        stream = ResponseStream(self, request_id, int(max_new_tokens))
        self._deferred_submits.append(
            (request_id, ids.astype(np.int32), int(max_new_tokens),
             (None if deadline_s is None
              else self._clock() + float(deadline_s)),
             priority, tenant, samp, adapter, stream))
        trace.instant("req.deferred", rid=request_id, restoring=True)
        return stream

    # -- pool hooks (fire inside pool.step, under the engine lock) -------
    def _on_admit(self, rid, slot, prompt_len):
        rec = self._live.get(rid)
        if rec is not None:
            rec.state = RequestState.PREFILLING
            hit = self._pool.last_admit_prefix_tokens
            trace.instant("req.prefilling", rid=rid, slot=slot,
                          prompt_tokens=prompt_len, prefix_hit_tokens=hit)
            slog.emit("req.admitted", rid=rid, slot=slot,
                      prompt_tokens=prompt_len, max_new_tokens=rec.max_new,
                      deadline_s=(None if rec.deadline_abs is None
                                  else round(rec.deadline_abs
                                             - rec.submit_t, 6)),
                      queue_depth=self._pool.queue_depth,
                      prefix_hit_tokens=hit)

    def _on_token(self, rid, tok):
        rec = self._live.get(rid)
        if rec is None:
            return
        # deliver BEFORE committing: if delivery faults, the token is not
        # in rec.tokens yet, so recovery re-prefills without it and greedy
        # decode regenerates exactly this token
        rec.stream._put_token(int(tok))
        now = self._clock()
        if rec.first_t is None:
            rec.first_t = now
            rec.state = RequestState.DECODING
            trace.instant("req.decoding", rid=rid,
                          ttft_s=now - rec.submit_t)
            self._h_ttft.observe(now - rec.submit_t)
            if self._slo is not None:
                self._slo.observe_latency("ttft", now - rec.submit_t)
        else:
            self._h_itl.observe(now - rec.last_t)
            if self._slo is not None:
                self._slo.observe_latency("inter_token", now - rec.last_t)
        rec.last_t = now
        rec.tokens.append(int(tok))
        if self._journal is not None:
            # buffered: the tick's deltas ride ONE commit record at the
            # tick's flush
            self._jl_tick_toks.setdefault(rec.rid, []).append(int(tok))
        self._c_tokens.inc()
        self._tokens_total += 1

    def _on_finish(self, rid, tokens, reason):
        rec = self._live.pop(rid, None)
        if rec is None:
            return
        self._pool.collect(rid)  # frees the rid; tokens already streamed
        self._c_done.inc()
        # the engine's record, not the pool's `tokens`: after a recovery
        # the pool saw only the post-resubmit tail
        self._finalize(rec, RequestState.DONE, reason, rec.tokens)

    def _on_resume(self, rid, info):
        """A preempted request's K/V were restored and its slot
        re-activated (fires inside the pool's refill)."""
        rec = self._live.get(rid)
        if rec is None:
            return
        rec.state = RequestState.DECODING
        self._c_resumes.inc()
        now = self._clock()
        wait_s = None if rec.preempted_at is None \
            else round(now - rec.preempted_at, 6)
        rec.preempted_at = None
        # the inter-token clock restarts at the resume: the parked wait
        # is scheduler time, and counting it as one token gap would feed
        # a preempting ladder the violation that keeps it preempting
        if rec.last_t is not None:
            rec.last_t = now
        trace.instant("sched.resume", rid=rid, slot=info.get("slot"),
                      blocks_remapped=info.get("blocks_remapped"),
                      blocks_uploaded=info.get("blocks_uploaded"),
                      wait_s=wait_s)
        slog.emit("sched.resume", rid=rid, slot=info.get("slot"),
                  blocks_remapped=info.get("blocks_remapped"),
                  blocks_uploaded=info.get("blocks_uploaded"),
                  committed_tokens=info.get("committed_tokens"),
                  wait_s=wait_s)

    # -- disaggregated hand-off and live migration ------------------------
    def _on_prefill_done(self, rid) -> None:
        """Pool hook (prefill role): ``rid``'s prompt is resident and its
        first token committed.  The export sweep at the tick's edge does
        the download and the file write; the hook fires inside
        ``pool.step`` and stays cheap."""
        self._export_ready.append(rid)

    def _export_sweep(self) -> None:
        """Export every prefill-complete request queued this tick: write
        its transfer file (the ``xfer.write`` seam; the file is written
        before the allocator is touched), fire ``on_handoff(rid, info)``
        with everything the decode tier needs -- before the tier-terminal
        ``HANDED_OFF`` finalize, so the front's hand-off record exists
        before the stream closes -- and end the tier's part.  A failed
        export degrades, never loses: the parked K/V is cancelled and the
        hand-off carries ``path=None``, for a prompt + committed resubmit
        on the decode tier (byte-identical under greedy decoding)."""
        if not self._export_ready:
            return
        ready, self._export_ready = self._export_ready, []
        for rid in ready:
            if not self._pool.has_prefill_done(rid):
                continue  # cancelled / expired / recovered away
            rec = self._live.get(rid)
            if rec is None:
                try:
                    self._pool.cancel(rid)
                except NotFoundError:
                    pass
                continue
            error = None
            try:
                info = self._pool.export_kv(rid)
            except BaseException as e:  # noqa: BLE001 - degrade, not lose
                error = "%s: %s" % (type(e).__name__, str(e)[:200])
                try:
                    self._pool.cancel(rid)
                except NotFoundError:
                    pass
                info = {"rid": rid, "path": None, "transfer_bytes": 0,
                        "blocks_written": 0,
                        "committed_tokens": len(rec.tokens)}
            self._live.pop(rid, None)
            info = dict(info)
            info.update(
                prompt=rec.prompt, tokens=list(rec.tokens),
                prompt_len=rec.prompt_len, max_new_tokens=rec.max_new,
                priority=rec.priority, tenant=rec.tenant,
                deadline_abs=rec.deadline_abs, submit_t=rec.submit_t,
                exported_at=self._clock(), error=error)
            if self._c_handed_off is not None:
                self._c_handed_off.inc()
            trace.instant("xfer.export", rid=rid,
                          transfer_bytes=info["transfer_bytes"],
                          blocks=info["blocks_written"],
                          committed_tokens=info["committed_tokens"],
                          degraded=error is not None or None)
            slog.emit("xfer.export", rid=rid,
                      transfer_bytes=info["transfer_bytes"],
                      blocks=info["blocks_written"],
                      committed_tokens=info["committed_tokens"],
                      error=error)
            if self.on_handoff is not None:
                self.on_handoff(rid, info)
            self._finalize(rec, RequestState.HANDED_OFF, "handoff",
                           rec.tokens)

    def adopt_transfer(self, request_id, input_ids, tokens,
                       max_new_tokens: int, priority=0, tenant=None,
                       deadline_abs=None, sampling=None,
                       adapter: int = 0) -> dict:
        """Decode-role admission of one handed-off request: ``input_ids``
        + committed ``tokens`` are the ground truth, the transfer file (if
        present and exact) the K/V fast path.  The request re-parks in the
        spill tier through ``adopt_spill`` and resumes at the next refill
        with no re-prefill; any miss (stale, alien or missing file) falls
        back to a prompt + committed resubmit, byte-identical either way.
        Committed tokens are not replayed into the returned stream: the
        front delivered them off the prefill tier's stream.

        Returns ``{"stream": ResponseStream, "adopted_from_file": bool}``.
        No queue-depth gate: admission control ran at the prefill tier's
        door, and refusing a hand-off here would drop a request both tiers
        already invested in."""
        if self.role != "decode":
            raise PreconditionNotMetError(
                "adopt_transfer is the decode tier's admission path (this "
                "engine's role is %r)" % (self.role,))
        return self._adopt_live(request_id, input_ids, tokens,
                                max_new_tokens, priority, tenant,
                                deadline_abs, sampling, adapter)

    def adopt_migration(self, request_id, input_ids, tokens,
                        max_new_tokens: int, priority=0, tenant=None,
                        deadline_abs=None, sampling=None,
                        adapter: int = 0) -> dict:
        """Fleet live-migration admission: the mechanics of
        :meth:`adopt_transfer` (the transfer file as the K/V fast path,
        prompt + committed resubmit as the fallback) for fused engines
        that move live requests among peers.  A prefill-role engine
        refuses: it has no decode step to finish the request with."""
        if self.role == "prefill":
            raise PreconditionNotMetError(
                "a prefill-role engine cannot adopt a migrated request: it "
                "has no decode step to finish it with")
        return self._adopt_live(request_id, input_ids, tokens,
                                max_new_tokens, priority, tenant,
                                deadline_abs, sampling, adapter)

    def _adopt_live(self, request_id, input_ids, tokens,
                    max_new_tokens: int, priority=0, tenant=None,
                    deadline_abs=None, sampling=None,
                    adapter: int = 0) -> dict:
        """The one adoption body behind :meth:`adopt_transfer` and
        :meth:`adopt_migration`: the role gates differ, the mechanics do
        not.  ``sampling`` is the donor's 5-list (or a parsed config); the
        adapter must name a servable bank row HERE (checked before any
        state lands: a fleet hot-loads the adapter and retries).  The
        journal records the adoption (admit + the committed history)
        before the request can decode; the adopter observes ITL only (TTFT
        belongs to the prefill tier or the donor)."""
        with self._lock:
            if self._draining:
                raise PreconditionNotMetError(
                    "engine is draining/shut down: hand-offs are stopped")
            if request_id in self._live:
                raise DuplicateRequestError(
                    "request_id %r is already live on this engine"
                    % (request_id,))
            priority = _normalize_priority(priority)
            if isinstance(sampling, (list, tuple)) \
                    and not isinstance(sampling, _SamplingConfig):
                sampling = _samp_from_json(sampling)
            adapter = self._pool._check_adapter(adapter)
            ids = np.asarray(input_ids).astype(np.int32)
            toks = [int(t) for t in tokens]
            now = self._clock()
            stream = ResponseStream(self, request_id, int(max_new_tokens))
            rec = _Record(request_id, stream, ids, int(max_new_tokens),
                          deadline_abs, now, priority=priority,
                          tenant=tenant, sampling=sampling, adapter=adapter)
            rec.tokens = list(toks)
            if toks:
                rec.first_t = rec.last_t = now
            if self._journal is not None:
                # write-ahead across the hand-off: a crash mid-adopt
                # replays prompt + committed, and re-adopts the file if
                # it is still exact
                self._check_journal_rid(request_id)
                try:
                    self._journal_admit(
                        request_id, ids, max_new_tokens,
                        (None if deadline_abs is None
                         else max(0.001, deadline_abs - now)),
                        priority, tenant, sampling=sampling,
                        adapter=adapter)
                    if toks:
                        self._jl_tick_toks.setdefault(
                            request_id, []).extend(toks)
                        self._journal_flush()
                except Exception as e:  # noqa: BLE001 - reject, typed
                    raise JournalWriteError(
                        "hand-off rejected: the request journal could not "
                        "record the adoption (%s: %s); retry"
                        % (type(e).__name__, str(e)[:200])) from e
            adopted = self._pool.adopt_spill(
                request_id, ids, toks, int(max_new_tokens),
                priority=priority, tenant=tenant, deadline=deadline_abs)
            if adopted:
                rec.state = RequestState.PREEMPTED
                rec.preempted_at = now
            else:
                self._resubmit_record(rec)
            self._live[request_id] = rec
            self._c_submitted.inc()
            trace.instant("xfer.adopt", rid=request_id, from_file=adopted,
                          committed_tokens=len(toks))
            slog.emit("xfer.adopt", rid=request_id,
                      adopted_from_file=adopted, committed_tokens=len(toks),
                      prompt_tokens=int(ids.shape[0]))
        self._wake.set()
        return {"stream": stream, "adopted_from_file": bool(adopted)}

    def migrate_out(self, request_id) -> dict:
        """Give one live request up for adoption by a peer engine (the
        donor half of fleet live migration).

        A DECODING request on the disk spill tier is preempted (its K/V
        land in a transfer file under the shared spill naming) and then
        detached: the file stays, the pool forgets the request, and the
        peer resumes it through ``adopt_spill`` with no re-prefill.
        Anything else (queued, prefilling, host-tier parked, preemption
        refused) is cancelled here: the returned prompt + committed entry
        is the ground truth, and the peer's resubmit regenerates it
        byte-identically under greedy decoding.  This engine finalizes its
        side ``HANDED_OFF``/"migrated" and returns ``{"rid", "prompt",
        "tokens", "max_new", "priority", "tenant", "deadline_abs",
        "retries", "sampling", "adapter", "spill_path"}``."""
        with self._lock:
            rec = self._live.get(request_id)
            if rec is None:
                raise NotFoundError(
                    "request_id %r is not live on this engine"
                    % (request_id,))
            pool = self._pool
            spill_path = None
            if rec.state == RequestState.DECODING \
                    and pool.spill_tier == "disk" \
                    and pool.can_preempt(rec.rid):
                try:
                    self._do_preempt(rec, "migrate")
                except Exception:  # noqa: BLE001 - degrade to resubmit
                    pass
            if rec.state == RequestState.PREEMPTED:
                try:
                    spill_path = pool.detach_spilled(rec.rid)["path"]
                except (NotFoundError, PreconditionNotMetError):
                    # host-tier parked (no file) or raced away: the entry
                    # still carries the whole resume state
                    pool.cancel(rec.rid)
            else:
                pool.cancel(rec.rid)
            self._live.pop(request_id, None)
            entry = {"rid": rec.rid, "prompt": rec.prompt,
                     "tokens": list(rec.tokens), "max_new": rec.max_new,
                     "priority": rec.priority, "tenant": rec.tenant,
                     "deadline_abs": rec.deadline_abs,
                     "retries": rec.retries,
                     "sampling": _samp_json(rec.sampling),
                     "adapter": int(rec.adapter),
                     "spill_path": spill_path}
            trace.instant("sched.migrate_out", rid=rec.rid,
                          spilled=spill_path is not None,
                          committed_tokens=len(rec.tokens))
            slog.emit("sched.migrate_out", rid=rec.rid,
                      spilled=spill_path is not None,
                      committed_tokens=len(rec.tokens),
                      remaining=rec.max_new - len(rec.tokens))
            self._finalize(rec, RequestState.HANDED_OFF, "migrated",
                           rec.tokens)
            self._journal_flush()
            return entry

    # -- preemption and the degradation ladder ----------------------------
    def preempt(self, request_id=None, reason: str = "manual"):
        """Evict one decoding request into the host spill tier; it resumes
        byte-identically when the pool next has room for it, and its state
        is ``PREEMPTED`` meanwhile.

        With ``request_id=None`` the engine picks the victim -- the lowest
        priority decoding request, youngest first -- and returns its id,
        or None when nothing is preemptable.  An explicit id that is not
        live raises ``NotFoundError``; the pool's typed errors pass
        through."""
        with self._lock:
            if request_id is None:
                victims = [r for r in self._live.values()
                           if r.state == RequestState.DECODING
                           and self._pool.can_preempt(r.rid)]
                if not victims:
                    return None
                rec = min(victims, key=lambda r: (r.priority, -r.submit_t))
            else:
                rec = self._live.get(request_id)
                if rec is None:
                    raise NotFoundError(
                        "request_id %r is not live on this engine"
                        % (request_id,))
            return self._do_preempt(rec, reason)

    def _do_preempt(self, rec: _Record, reason: str):
        """Preempt ``rec`` (the caller holds the lock) and record the
        decision in the flight recorder and the structured log."""
        info = self._pool.preempt(rec.rid)
        rec.state = RequestState.PREEMPTED
        rec.preempts += 1
        rec.preempted_at = self._clock()
        self._c_preempts.inc()
        self._c_spill_bytes.inc(info["spill_bytes"])
        trace.instant("sched.preempt", rid=rec.rid, reason=reason,
                      priority=rec.priority,
                      committed_tokens=info["committed_tokens"],
                      blocks_spilled=info["blocks_spilled"],
                      spill_bytes=info["spill_bytes"])
        slog.emit("sched.preempt", rid=rec.rid, reason=reason,
                  priority=rec.priority, tenant=rec.tenant,
                  committed_tokens=info["committed_tokens"],
                  blocks_spilled=info["blocks_spilled"],
                  blocks_freed=info["blocks_freed"],
                  spill_bytes=info["spill_bytes"],
                  degrade_level=self._degrade_level or None)
        return rec.rid

    def _degrade_eval(self) -> None:
        """One ladder evaluation per tick, before the pool step, so a
        preemption frees a slot this tick's refill can hand to waiting
        higher-priority work (the caller holds the lock).  Down one rung
        per alerting tick once ``dwell`` ticks passed since the last
        change; up one rung after ``clear`` alert-free ticks."""
        if not self._degrade_on:
            return
        alerting = self._slo.alerting_names()
        self._degrade_ticks_since_change += 1
        if alerting:
            self._degrade_clean_ticks = 0
            if self._degrade_level < self._degrade_max and \
                    self._degrade_ticks_since_change >= self._degrade_dwell:
                self._set_degrade_level(self._degrade_level + 1, alerting)
        else:
            self._degrade_clean_ticks += 1
            if self._degrade_level > 0 and \
                    self._degrade_clean_ticks >= self._degrade_clear:
                self._set_degrade_level(self._degrade_level - 1, alerting)
                self._degrade_clean_ticks = 0
        if self._degrade_level >= 1:
            self._preempt_for_priority()

    def _set_degrade_level(self, level: int, alerting) -> None:
        """Move the ladder to ``level``.  Rung 2 (reduce spec-K) acts on
        a speculative pool: engaging it remembers the runtime setting and
        drops to 1; disengaging restores that setting, unless an operator
        re-tuned meanwhile.  On a plain pool it does nothing."""
        prev, self._degrade_level = self._degrade_level, level
        self._degrade_ticks_since_change = 0
        self._degrade_transitions += 1
        actions = []
        if level >= 1:
            actions.append("preempt-low-priority")
        spec = getattr(self._pool, "set_spec_k", None)
        if spec is not None and self._spec_k_full is not None \
                and self._spec_k_full > 1:
            if level >= 2 and prev < 2:
                self._spec_k_saved = self._pool.spec_k_active
                if self._spec_k_saved != 1:
                    spec(1)
                    actions.append("spec_k->1")
            elif level < 2 and prev >= 2 \
                    and self._spec_k_saved is not None:
                if self._pool.spec_k_active == 1 \
                        and self._spec_k_saved != 1:
                    spec(self._spec_k_saved)
                    actions.append("spec_k->%d" % self._spec_k_saved)
                self._spec_k_saved = None
        if level >= 3:
            actions.append("admission-floor>=%d" % self._degrade_floor)
        if self._g_degrade is not None:
            self._g_degrade.set(level)
        event = "sched.degrade" if level > prev else "sched.restore"
        trace.instant(event, level=level, prev=prev,
                      alerting=list(alerting) or None)
        slog.emit(event, level=level, prev=prev,
                  alerting=list(alerting) or None, actions=actions or None)

    def _preempt_for_priority(self) -> None:
        """The preempt rung: evict ONE low-priority decoding request per
        tick, and only when a STRICTLY higher-priority request the refill
        could admit is waiting and the pool is out of slots (or its
        chosen candidate is block-starved)."""
        pool = self._pool
        # a tenant at its cap would not be admitted anyway: preempting for
        # it would only thrash the spill tier
        queued = [r for r in self._live.values()
                  if r.state == RequestState.QUEUED
                  and not pool.tenant_at_cap(r.tenant)]
        if not queued:
            return
        if pool.active_count + pool.prefilling_count < pool.slots \
                and not pool.admission_blocked:
            return
        pmax = max(r.priority for r in queued)
        victims = [r for r in self._live.values()
                   if r.state == RequestState.DECODING
                   and r.priority < pmax and pool.can_preempt(r.rid)]
        if not victims:
            return
        rec = min(victims, key=lambda r: (r.priority, -r.submit_t))
        self._do_preempt(rec, "degrade")

    def degradation_snapshot(self) -> dict:
        """The ladder's state (folded into ``GET /slo``);
        ``enabled=False`` with zeros when no ladder is configured."""
        out = {"enabled": self._degrade_on,
               "level": self._degrade_level,
               "max_level": self._degrade_max,
               "admit_floor": self._degrade_floor,
               "transitions": self._degrade_transitions,
               "preempted_requests": sum(
                   1 for r in self._live.values()
                   if r.state == RequestState.PREEMPTED)}
        if self._spec_k_full is not None:
            out["spec_k_active"] = self._pool.spec_k_active
            out["spec_k_full"] = self._spec_k_full
        return out

    # -- lifecycle transitions -------------------------------------------
    def _finalize(self, rec: _Record, state: str, reason: str, tokens,
                  error: Optional[str] = None) -> None:
        """Every terminal path ends here, so a request's trace timeline,
        the SLO tracker and the structured log see every terminal."""
        now = self._clock()
        toks = np.asarray(tokens if tokens is not None else rec.tokens,
                          np.int32)
        rec.state = state
        if self._journal is not None:
            # commit before terminal: this rid's same-tick deltas must
            # reach the journal before the record that stops its replay
            self._materialize_tick_commits()
            self._jl_pending.append(
                {"t": "terminal", "rid": _jsonable_rid(rec.rid),
                 "state": state, "reason": reason})
        trace.instant("req." + state.lower(), rid=rec.rid, reason=reason,
                      new_tokens=int(toks.size), error=error)
        if self._slo is not None:
            self._slo.observe_terminal(state)
        slog.emit("req.terminal", rid=rec.rid, state=state,
                  finish_reason=reason, new_tokens=int(toks.size),
                  ttft_s=(None if rec.first_t is None
                          else round(rec.first_t - rec.submit_t, 6)),
                  total_s=round(now - rec.submit_t, 6),
                  retries=rec.retries or None, error=error)
        rec.stream._finalize(StreamStatus(
            request_id=rec.rid, state=state, finish_reason=reason,
            tokens=toks, prompt_tokens=rec.prompt_len,
            new_tokens=int(toks.size),
            ttft_s=(None if rec.first_t is None
                    else rec.first_t - rec.submit_t),
            total_s=now - rec.submit_t, error=error))

    def cancel(self, request_id) -> bool:
        """Abort a live request (queued, prefilling, decoding or
        preempted): its slot, blocks and spilled copies are freed and its
        stream ends ``CANCELLED`` with the tokens emitted so far.  False
        if the id is not live -- idempotent."""
        with self._lock:
            rec = self._live.pop(request_id, None)
            if rec is None:
                if request_id is not None:
                    # a submit deferred while RESTORING is cancellable
                    for i, entry in enumerate(self._deferred_submits):
                        if entry[0] == request_id:
                            (rid, ids, max_new, _dl, priority, tenant,
                             samp, adapter, stream) = entry
                            del self._deferred_submits[i]
                            rec = _Record(rid, stream, ids, max_new, None,
                                          self._clock(), priority=priority,
                                          tenant=tenant, sampling=samp,
                                          adapter=adapter)
                            self._c_cancelled.inc()
                            self._finalize(rec, RequestState.CANCELLED,
                                           "cancelled", [])
                            return True
                return False
            self._pool.cancel(request_id)
            self._c_cancelled.inc()
            self._finalize(rec, RequestState.CANCELLED, "cancelled",
                           rec.tokens)
            # an out-of-tick terminal is made durable now
            self._journal_flush()
            return True

    def _expire(self) -> None:
        now = self._clock()
        for rid, rec in list(self._live.items()):
            if rec.deadline_abs is not None and now >= rec.deadline_abs:
                self._live.pop(rid)
                self._pool.cancel(rid)
                self._c_expired.inc()
                self._finalize(rec, RequestState.EXPIRED, "deadline",
                               rec.tokens)

    def _fail_record(self, rec: _Record, exc: BaseException,
                     why: str) -> None:
        """Finalize one victim FAILED, carrying the retry count and the
        root error."""
        self._c_failed.inc()
        self._finalize(
            rec, RequestState.FAILED, "error", rec.tokens,
            error=("%s (retries=%d/%d): %s"
                   % (why, rec.retries, self.max_retries,
                      str(exc)[:400]))[:500])

    def _resubmit_record(self, rec: _Record) -> None:
        """The recovery primitive: resubmit one victim as prompt +
        committed tokens with its remaining budget, its scheduling
        metadata and its sampling stream advanced by the committed
        count."""
        ids = rec.prompt if not rec.tokens else np.concatenate(
            [rec.prompt, np.asarray(rec.tokens, np.int32)])
        self._pool.submit(ids, rec.max_new - len(rec.tokens),
                          request_id=rec.rid, priority=rec.priority,
                          tenant=rec.tenant, deadline=rec.deadline_abs,
                          adapter=rec.adapter,
                          _sampling=self._pool._resubmit_sampling(
                              rec.sampling, len(rec.tokens)))
        rec.state = RequestState.QUEUED
        rec.preempted_at = None

    def _recover(self, exc: BaseException) -> None:
        """A pool step failed.  None of the pool's state can be trusted,
        but the engine's host records can: transient victims with retries
        left are resubmitted as prompt + committed (greedy requests
        continue token-identically); permanent errors and exhausted
        budgets end FAILED.  ``pool.reset()`` keeps every step key and
        captured graph and zeroes the cache in place, and marks the step
        buffers for a fresh upload, so a recovery costs re-prefills, never
        a capture.  If the reset itself raises (a sticky CUDA error), the
        survivors end FAILED and the error propagates."""
        kind = faults.classify_error(exc)
        survivors = []
        for rid, rec in list(self._live.items()):
            self._live.pop(rid)
            if kind == "permanent":
                self._fail_record(rec, exc, "permanent step error")
            elif rec.retries >= self.max_retries:
                self._fail_record(rec, exc, "retry budget exhausted")
            else:
                rec.retries += 1
                survivors.append(rec)
        try:
            self._pool.reset()
        except Exception as reset_exc:  # noqa: BLE001 - the reset died
            for rec in survivors:
                self._fail_record(rec, reset_exc, "pool rebuild failed")
            raise
        self._c_recoveries.inc()
        trace.instant("recovery", kind=kind, error=str(exc)[:200],
                      survivors=len(survivors))
        resubmitted = 0
        for rec in survivors:  # dict order is submit order: FIFO kept
            try:
                self._resubmit_record(rec)
            except Exception as sub_exc:  # noqa: BLE001 - per victim
                self._fail_record(rec, sub_exc, "resubmit failed")
                continue
            self._live[rec.rid] = rec
            self._c_recovered.inc()
            trace.instant("recovery.resubmit", rid=rec.rid,
                          retries=rec.retries,
                          committed_tokens=len(rec.tokens))
            resubmitted += 1
        self._health.note_recovery(resubmitted)
        slog.emit("engine.recovery", kind=kind, survivors=len(survivors),
                  resubmitted=resubmitted, error=str(exc)[:200])

    # -- crash durability: journal, checkpoint, restore -------------------
    def _check_journal_rid(self, request_id) -> None:
        """A journaled engine only accepts JSON-round-trippable request
        ids (int or str): anything else could not replay under the same
        identity."""
        if request_id is None or isinstance(request_id, str):
            return
        if isinstance(request_id, (int, np.integer)) \
                and not isinstance(request_id, bool):
            return
        raise InvalidArgumentError(
            "a journaled engine needs a JSON-safe request_id (int or "
            "str, or None for auto-assignment) -- got %r; the journal "
            "must replay the request under the same identity"
            % (request_id,))

    def _journal_admit(self, rid, ids, max_new, deadline_s, priority,
                       tenant, sampling=None, adapter=0) -> None:
        """Make ONE admission durable: drain any backlog first (journal
        order is replay correctness: a reused rid must not see an old
        request's stranded commits replayed onto it), then append and
        sync the admit record.  On failure a closing terminal is queued
        (if the admit frame landed and only the sync failed, restore must
        not resurrect a request its caller was told was rejected) and the
        error propagates."""
        try:
            if self._jl_pending or self._jl_tick_toks:
                self._journal_flush()
                if self._jl_pending:
                    raise JournalWriteError(
                        "the journal has a backlog of %d unflushed "
                        "records (append failures) that must land "
                        "before a new admit record can -- retry"
                        % (len(self._jl_pending),))
            self._journal_append(
                {"t": "admit", "rid": _jsonable_rid(rid),
                 "ids": [int(t) for t in ids],
                 "max_new": int(max_new),
                 "priority": int(priority), "tenant": tenant,
                 "deadline_s": (None if deadline_s is None
                                else float(deadline_s)),
                 "sampling": _samp_json(sampling),
                 "adapter": int(adapter),
                 # wall clock (engine clocks do not cross processes):
                 # restore deducts the elapsed time from the deadline
                 "ts": time.time()})
            self._journal.sync()
        except Exception:
            self._jl_pending.append(
                {"t": "terminal", "rid": _jsonable_rid(rid),
                 "state": RequestState.FAILED,
                 "reason": "admit-unjournaled"})
            self._journal_flush()
            raise

    def _materialize_tick_commits(self) -> None:
        """Fold this tick's buffered token deltas into ONE pending commit
        record."""
        if self._jl_tick_toks:
            self._jl_pending.append(
                {"t": "commit",
                 "toks": [[_jsonable_rid(r), ts] for r, ts
                          in self._jl_tick_toks.items()]})
            self._jl_tick_toks = {}

    def _journal_append(self, rec: dict) -> int:
        """Append one record, retrying once on a transient failure.  Each
        caught fault emits a ``journal.error`` trace event and log line
        and bumps ``serving_journal_errors_total`` (so injected
        ``journal.append`` faults reconcile with the recorder); a second
        failure propagates."""
        for attempt in (0, 1):
            try:
                n = self._journal.append(rec)
            except Exception as e:  # noqa: BLE001 - classify + retry
                retry = attempt == 0 \
                    and faults.classify_error(e) == "transient"
                self._c_journal_errors.inc()
                trace.instant("journal.error", record=rec.get("t"),
                              error=type(e).__name__, retried=retry)
                slog.emit("journal.error", record=rec.get("t"),
                          error=str(e)[:200], retried=retry)
                if not retry:
                    raise
                continue
            self._c_journal_records.inc()
            self._c_journal_bytes.inc(n)
            return n
        raise AssertionError("unreachable")  # pragma: no cover

    def _journal_flush(self) -> None:
        """Drain this tick's commit batch and any backlog into the
        journal in order, stopping (not raising) at a persistent append
        failure: the journal falls behind and catches up later.  One
        fsync a flush under ``journal_fsync="tick"``."""
        j = self._journal
        if j is None:
            return
        self._materialize_tick_commits()
        if not self._jl_pending:
            return
        while self._jl_pending:
            try:
                self._journal_append(self._jl_pending[0])
            except Exception:  # noqa: BLE001 - stays pending, serve on
                break
            self._jl_pending.pop(0)
        try:
            j.sync()
        except OSError as e:
            self._c_journal_errors.inc()
            trace.instant("journal.error", record="sync",
                          error=type(e).__name__, retried=False)
            slog.emit("journal.error", record="sync", error=str(e)[:200],
                      retried=False)

    def checkpoint(self, path: Optional[str] = None) -> dict:
        """Snapshot the live request set at a tick boundary (the engine
        lock) and COMPACT the journal to header + one checkpoint record
        (tmp file, fsync, atomic rename).  With ``path=None`` the engine's
        own journal is compacted in place (needs ``journal_path=``); with
        a path, a standalone snapshot journal is written there and the
        live journal is left alone.  Returns ``{"path", "bytes",
        "records", "live_requests"}``."""
        with self._lock:
            if self._journal is None and path is None:
                raise PreconditionNotMetError(
                    "checkpoint() needs either a journaled engine "
                    "(journal_path= at construction) or an explicit "
                    "path to write the snapshot journal to")
            self._journal_flush()
            now = self._clock()
            live = []
            for rec in self._live.values():
                live.append({
                    "rid": _jsonable_rid(rec.rid),
                    "ids": [int(t) for t in rec.prompt],
                    "tokens": list(rec.tokens),
                    "max_new": rec.max_new,
                    "priority": rec.priority,
                    "tenant": rec.tenant,
                    # the REMAINING budget: absolute stamps on this
                    # engine's clock mean nothing in another process
                    "deadline_s": (None if rec.deadline_abs is None
                                   else max(0.001,
                                            rec.deadline_abs - now)),
                    "ts": time.time(),
                    "sampling": _samp_json(rec.sampling),
                    "adapter": int(rec.adapter),
                    "retries": rec.retries})
            ckpt = {"t": "checkpoint", "live": live}
            if self._journal is not None:
                info = self._journal.compact([ckpt], path=path)
                if path is None or os.path.abspath(path) \
                        == os.path.abspath(self._journal.path):
                    # the snapshot supersedes any stranded backlog: its
                    # tokens are in rec.tokens already, and appending
                    # them after it would double-apply at replay
                    self._jl_pending = []
                    self._jl_tick_toks = {}
            else:
                w = JournalWriter(path, self._pool.config_fingerprint())
                try:
                    info = w.compact([ckpt])
                finally:
                    w.close()
            self._c_checkpoints.inc()
            trace.instant("journal.checkpoint", live=len(live),
                          bytes=info["bytes"])
            slog.emit("journal.checkpoint", path=info["path"],
                      live_requests=len(live), bytes=info["bytes"])
            info["live_requests"] = len(live)
            return info

    def _begin_restore(self, retry_after_s: float = 1.0) -> None:
        """Enter RESTORING: ``health()`` reports it and submits are
        deferred until ``_end_restore``."""
        with self._lock:
            self._restoring = True
            self._restore_retry_after_s = float(retry_after_s)

    def _end_restore(self) -> None:
        """Leave RESTORING and admit every deferred submit through the
        normal path, under one lock acquisition (no foreign submit can
        interleave)."""
        with self._lock:
            self._restoring = False
            deferred, self._deferred_submits = self._deferred_submits, []
            for args in deferred:
                self._admit_deferred(*args)
        if deferred:
            self._wake.set()

    def _admit_deferred(self, rid, ids, max_new, deadline_abs, priority,
                        tenant, samp, adapter, stream) -> None:
        """Admit one deferred submit.  A failure finalizes its stream
        FAILED: its caller holds the stream, so the error travels
        there."""
        with self._lock:
            now = self._clock()
            try:
                if self._draining:
                    raise PreconditionNotMetError(
                        "engine drained while the submit was deferred")
                if self._pool.queue_depth >= self.max_queue:
                    raise QueueFullError(
                        "queue filled while the submit was deferred; "
                        "back off and resubmit")
                rid = self._pool.submit(ids, int(max_new), request_id=rid,
                                        priority=priority, tenant=tenant,
                                        deadline=deadline_abs,
                                        adapter=adapter, _sampling=samp)
            except Exception as e:  # noqa: BLE001 - to the stream
                rec = _Record(rid, stream, ids, int(max_new), deadline_abs,
                              now, priority=priority, tenant=tenant,
                              sampling=samp, adapter=adapter)
                self._c_failed.inc()
                self._finalize(rec, RequestState.FAILED, "error", [],
                               error="deferred admission failed: %s: %s"
                               % (type(e).__name__, str(e)[:200]))
                return
            # an automatic id exists from here: the stream learns it
            # before any token can flow
            stream.request_id = rid
            rec = _Record(rid, stream, ids, int(max_new), deadline_abs,
                          now, priority=priority, tenant=tenant,
                          sampling=samp, adapter=adapter)
            self._live[rid] = rec
            if self._journal is not None:
                try:
                    self._journal_admit(
                        rid, ids, max_new,
                        (None if deadline_abs is None
                         else max(0.001, deadline_abs - now)),
                        priority, tenant, sampling=samp, adapter=adapter)
                except Exception as e:  # noqa: BLE001 - to the stream
                    self._pool.cancel(rid)
                    self._live.pop(rid, None)
                    self._c_failed.inc()
                    self._finalize(
                        rec, RequestState.FAILED, "error", [],
                        error="deferred admission not journalable: %s"
                        % (str(e)[:200],))
                    return
            self._c_submitted.inc()
            trace.instant("req.queued", rid=rid, deferred=True,
                          prompt_tokens=int(ids.shape[0]),
                          max_new_tokens=int(max_new))

    @staticmethod
    def _fingerprint_upgrade(fp: dict, mine: dict):
        """Triage of a journal whose header predates per-request sampling
        (its fingerprint carries pool-global ``temperature``/``top_k``/
        ``top_p``/``sampling_seed`` where this engine's carries the
        ``"sampling": "per-request"`` marker).  When the two agree on
        every other field, the journal replays through the resubmit path
        with the old global config applied per request: returns that
        config, or None when they genuinely disagree."""
        v1_keys = ("temperature", "top_k", "top_p", "sampling_seed")
        if "sampling" in fp or not all(k in fp for k in v1_keys):
            return None
        if mine.get("sampling") != "per-request" \
                or mine.get("lora") is not None:
            return None
        rest = {k: v for k, v in fp.items() if k not in v1_keys}
        mine_rest = {k: v for k, v in mine.items()
                     if k not in ("sampling", "lora")}
        if rest != mine_rest:
            return None
        return _SamplingConfig(
            float(fp["temperature"]), int(fp["top_k"]),
            float(fp["top_p"]), int(fp["sampling_seed"]) & 0xFFFFFFFF)

    def restore(self, path: str) -> dict:
        """Adopt the journal at ``path``: check its fingerprint against
        this engine's (``FingerprintMismatchError`` naming both sides),
        replay its longest valid prefix, and rebuild every live request.
        A PREEMPTED request whose disk-spill file is present and exact is
        re-parked in the spill tier (its K/V page back in at resume, no
        re-prefill); everything else resubmits as prompt + committed, so
        every greedy survivor finishes byte-identically with no new
        capture on warmed steps.  A request whose journaled history
        already ended (a torn tail ate its terminal) is finalized.

        The engine must be fresh.  While the replay runs it is RESTORING
        (submits deferred).  A journaled engine compacts the adopted
        state into its own journal afterwards.  Returns ``{
        "requests_replayed", "adopted_from_spill", "finished_at_restore",
        "tokens_replayed", "records", "records_dropped", "truncated",
        "journal_counts", "restore_s"}``."""
        t0 = time.perf_counter()
        with self._lock:
            if self._draining:
                raise PreconditionNotMetError(
                    "engine is draining/shut down: build a fresh engine "
                    "to restore into")
            if self._restoring:
                raise PreconditionNotMetError(
                    "a restore is already in progress on this engine: a "
                    "second concurrent replay would fail every duplicate "
                    "resubmit")
            if self._live or self._pool.queue_depth \
                    or self._pool.active_count:
                raise PreconditionNotMetError(
                    "restore() needs a fresh engine: %d live requests "
                    "are already being served (restore rebuilds the "
                    "live set from the journal, it does not merge)"
                    % (len(self._live),))
            self._restoring = True
            self._restore_retry_after_s = 1.0
        adopted = finished = replayed = tokens_replayed = 0
        try:
            with self._lock:
                fp, records, stats = read_journal(path)
                if stats["truncated"]:
                    self._c_journal_truncated.inc(stats["records_dropped"])
                    trace.instant("journal.truncated",
                                  dropped_records=stats["records_dropped"],
                                  dropped_bytes=stats["bytes_dropped"])
                    slog.emit("journal.truncated", path=path,
                              dropped_records=stats["records_dropped"],
                              dropped_bytes=stats["bytes_dropped"])
                mine = self._pool.config_fingerprint()
                legacy_samp = None
                if fp != mine:
                    legacy_samp = self._fingerprint_upgrade(fp, mine)
                    if legacy_samp is None:
                        raise FingerprintMismatchError(fp, mine)
                    slog.emit("journal.upgrade", path=path,
                              temperature=legacy_samp.temperature,
                              top_k=legacy_samp.top_k,
                              top_p=legacy_samp.top_p,
                              seed=legacy_samp.seed)
                live, counts = replay(records)
                now = self._clock()
                eos = self._pool.eos_id
                for entry in live:
                    rid = entry["rid"]
                    ids = np.asarray(entry["ids"], np.int32)
                    toks = entry["tokens"]
                    max_new = entry["max_new"]
                    deadline_s = entry["deadline_s"]
                    if deadline_s is not None and entry.get("ts"):
                        # the REMAINING budget: deduct the wall-clock
                        # time burned since the record was written
                        deadline_s = max(
                            0.001, float(deadline_s)
                            - max(0.0, time.time() - entry["ts"]))
                    deadline_abs = None if deadline_s is None \
                        else now + float(deadline_s)
                    msamp = entry.get("sampling")
                    if msamp is not None:
                        samp = _samp_from_json(msamp)
                    elif legacy_samp is not None:
                        samp = legacy_samp._replace(
                            seed=(legacy_samp.seed + replayed)
                            & 0xFFFFFFFF)
                    else:
                        samp = self._pool._resolve_sampling(
                            0.0, None, None, 0)
                    stream = ResponseStream(self, rid, max_new)
                    rec = _Record(rid, stream, ids, max_new, deadline_abs,
                                  now, priority=entry["priority"],
                                  tenant=entry["tenant"], sampling=samp,
                                  adapter=int(entry.get("adapter") or 0))
                    rec.retries = entry["retries"]
                    rec.tokens = list(toks)
                    # the committed history replays into the fresh
                    # stream: its consumer sees the whole token stream
                    for t in toks:
                        stream._put_token(int(t))
                    if toks:
                        rec.first_t = rec.last_t = now
                    self._c_replayed.inc()
                    replayed += 1
                    tokens_replayed += len(toks)
                    if len(toks) >= max_new or (
                            eos is not None and toks and toks[-1] == eos):
                        self._c_done.inc()
                        self._finalize(rec, RequestState.DONE,
                                       ("eos" if eos is not None
                                        and toks and toks[-1] == eos
                                        else "length"), rec.tokens)
                        finished += 1
                        continue
                    if legacy_samp is None and self._pool.adopt_spill(
                            rid, ids, toks, max_new,
                            priority=entry["priority"],
                            tenant=entry["tenant"],
                            deadline=deadline_abs):
                        rec.state = RequestState.PREEMPTED
                        rec.preempted_at = now
                        self._live[rid] = rec
                        adopted += 1
                        continue
                    try:
                        self._resubmit_record(rec)
                    except Exception as e:  # noqa: BLE001 - per victim
                        self._fail_record(rec, e, "restore resubmit failed")
                        continue
                    self._live[rid] = rec
                self._c_restores.inc()
                restore_s = time.perf_counter() - t0
                self._health.note_restore(restore_s)
                if self._journal is not None:
                    # a second crash replays from here
                    self.checkpoint()
                trace.instant("engine.restore", replayed=replayed,
                              adopted=adopted, finished=finished,
                              tokens=tokens_replayed)
                slog.emit("engine.restore", path=path,
                          requests_replayed=replayed,
                          adopted_from_spill=adopted,
                          finished_at_restore=finished,
                          tokens_replayed=tokens_replayed,
                          records=stats["records"],
                          records_dropped=stats["records_dropped"],
                          restore_s=round(restore_s, 6))
        finally:
            self._end_restore()
        self._wake.set()
        return {"requests_replayed": replayed,
                "adopted_from_spill": adopted,
                "finished_at_restore": finished,
                "tokens_replayed": tokens_replayed,
                "records": stats["records"],
                "records_dropped": stats["records_dropped"],
                "truncated": stats["truncated"],
                "journal_counts": counts,
                "restore_s": time.perf_counter() - t0}

    # -- the tick (one code path for both drive modes) --------------------
    def _tick(self) -> bool:
        tr = trace.active()
        if tr is None:
            return self._run_tick()
        return self._run_tick_traced(tr)

    def _run_tick_traced(self, tr) -> bool:
        """The traced tick: the same ``_run_tick`` inside a numbered
        ``tick`` span, plus compile events and the drop-counter mirror."""
        if tr is not self._tracer:
            with self._lock:
                self._tracer = tr
                self._trace_dropped_seen = 0
                self._compile_seen = None
        if self._compile_seen is None:
            with self._lock:
                # baseline before the tick, so a cold engine's first
                # traced tick reports its own compiles
                self._compile_seen = self._pool.compile_counts()
        with tr.span("tick", tick=tr.next_tick()):
            work = self._run_tick()
        counts = self._pool.compile_counts()
        if counts != self._compile_seen:
            for key, n in counts.items():
                if n != self._compile_seen.get(key):
                    tr.instant("compile", what=key, count=int(n))
            with self._lock:
                self._compile_seen = counts
        dropped = tr.recorder.dropped
        if dropped > self._trace_dropped_seen:
            self._c_trace_dropped.inc(dropped - self._trace_dropped_seen)
            with self._lock:
                self._trace_dropped_seen = dropped
        return work

    def _run_tick(self) -> bool:
        self._health.note_tick_start(self._clock())
        try:
            self._expire()
            # the ladder before the step: it reads the alert the last
            # tick's window roll produced, and it runs on idle ticks too,
            # or a drained engine could never step back up
            self._degrade_eval()
            if not self._live:
                self._observe_gauges()
                return False
            self._h_queue.observe(self._pool.queue_depth)
            try:
                with self._timer:
                    self._pool.step()
            except Exception as e:  # noqa: BLE001 - the step's blast radius
                self._health.note_error(self._clock(), e,
                                        faults.classify_error(e))
                self._recover(e)
            # the prefill tier's tick edge: export every prefill that
            # completed this step (nothing to do on other roles)
            self._export_sweep()
            self._observe_gauges()
            return bool(self._live)
        finally:
            # the tick's journal flush: commits and terminals of a
            # recovered tick are recorded too, and a flush failure leaves
            # records pending -- the engine never dies for it
            self._journal_flush()
            # the heartbeat closes even when recovery re-raises (a dead
            # loop is the supervisor's signal, not a stall), and the SLO
            # windows roll on every tick, idle ones included
            if self._slo is not None:
                self._slo.note_tick()
            self._health.note_tick_end(self._clock())

    def _observe_gauges(self) -> None:
        pool = self._pool
        self._g_queue.set(pool.queue_depth)
        self._g_active.set(pool.active_count)
        self._g_occupancy.set(pool.active_count / pool.slots)
        stats = pool.cache_stats()
        self._g_kv_bytes.set(stats["reachable_bytes"])
        if self._g_accept is not None:
            self._g_accept.set(pool.acceptance_stats()["acceptance_rate"])
        self._g_kv_resident.set(stats["pool_bytes"])
        if self._g_kv_free is not None:
            self._g_kv_free.set(stats["free_blocks"])
        if self._g_mesh_devices is not None:
            per_shard = stats["per_shard"]
            self._g_mesh_devices.set(stats["mesh"]["devices"])
            self._g_kv_resident_shard.set(per_shard[0]["pool_bytes"])
            self._g_kv_reachable_shard.set(
                max(e["reachable_bytes"] for e in per_shard))
        self._g_preempted.set(pool.preempted_count)
        if self._g_spilled_blocks is not None:
            self._g_spilled_blocks.set(stats["spilled_blocks"])
        if self._g_prefix_hit is not None or self._c_chunks is not None:
            pstats = pool.prefix_stats()
            if self._g_prefix_hit is not None:
                self._g_prefix_hit.set(pstats["hit_rate"])
                self._g_prefix_shared.set(pstats["blocks_shared_now"])
            if self._c_chunks is not None:
                # counter semantics: add the pool's delta since last tick
                total = pstats["prefill_chunks_total"]
                if total > self._chunks_seen:
                    self._c_chunks.inc(total - self._chunks_seen)
                    self._chunks_seen = total
        if self._timer.total:
            self._g_tps.set(self._tokens_total / self._timer.total)
            self._g_step.set(self._timer.step_time)
        # the cost gauges: one int compare a tick unless a step key was
        # counted or captured since the last refresh
        version = pool.cost_version()
        if version != self._cost_seen:
            self._cost_seen = version
            derived = pool.cost_report().get("derived") or {}
            if derived:
                self._g_step_flops.set(derived["step_flops"])
                self._g_step_bytes.set(derived["step_bytes_accessed"])
                if derived.get("hbm_reserved_bytes") is not None:
                    self._g_hbm_reserved.set(derived["hbm_reserved_bytes"])

    # -- drive mode 1: synchronous pump ----------------------------------
    def pump(self, steps: int = 1) -> bool:
        """Run up to ``steps`` ticks inline on the calling thread; True
        while live requests remain.  Refused while the background loop
        owns the engine."""
        if self._thread is not None:
            raise PreconditionNotMetError(
                "the engine owns a background step loop (start() was "
                "called); pump() is the synchronous drive mode -- don't "
                "mix them")
        if int(steps) < 1:
            raise InvalidArgumentError(
                "pump needs steps >= 1, got %r" % (steps,))
        work = bool(self._live)
        for _ in range(int(steps)):
            with self._lock:
                work = self._tick()
            if not work:
                break
        return work

    # -- drive mode 2: the owned background loop ---------------------------
    def start(self) -> "ServingEngine":
        """Start the owned step-loop thread; returns self.  The loop runs
        the same ``_tick`` as ``pump()`` on the pool's device and waits
        on an event only when a tick reports no work (a submit wakes
        it)."""
        with self._lock:
            if self._thread is not None:
                return self
            if self._draining:
                raise PreconditionNotMetError(
                    "engine was drained/shut down; build a new "
                    "ServingEngine instead of restarting this one")
            self._stop.clear()
            self._thread = self._spawn_loop()
        return self

    def _spawn_loop(self) -> threading.Thread:
        t = threading.Thread(target=self._loop, args=(self._loop_device,),
                             name="serving-engine-step-loop", daemon=True)
        t.start()
        return t

    def is_running(self) -> bool:
        """True when the background step loop owns the engine."""
        return self._thread is not None

    def _loop(self, device_index: Optional[int]) -> None:
        if device_index is not None:
            torch.cuda.set_device(device_index)
        while not self._stop.is_set():
            try:
                with self._lock:
                    work = self._tick()
            except Exception as e:  # noqa: BLE001
                # recovery already failed the live requests; record what
                # killed the tick, with the flight recorder's tail
                with self._lock:
                    self._health.note_error(self._clock(), e, "loop")
                    self._dump_flight("loop-error")
                work = False
            if not work:
                self._wake.wait(0.002)
                self._wake.clear()

    def restart_loop(self) -> bool:
        """Supervisor entry point: replace a DEAD background loop with a
        fresh one (counted in ``serving_engine_restarts_total``).  False,
        with no side effect, while the old thread is alive, when no loop
        was ever started, or once draining/shutdown began."""
        with self._lock:
            t = self._thread
            if t is None or t.is_alive() or self._draining \
                    or self._stop.is_set():
                return False
            t.join(timeout=0)
            self._thread = self._spawn_loop()
            self._c_restarts.inc()
            self._health.note_restart(self._clock())
            trace.instant("restart")
            slog.emit("engine.restart")
        self._wake.set()
        return True

    def _note_stall(self) -> None:
        """Supervisor hook: one stall EPISODE opened on the heartbeat."""
        self._c_stalled.inc()
        trace.instant("stall")
        slog.emit("engine.stall")

    def _dump_flight(self, reason: str) -> None:
        """Attach the flight recorder's tail to the health record; no-op
        when no tracer was ever active."""
        tr = trace.active() or self._tracer
        if tr is not None:
            self._health.note_flight_dump(self._clock(), reason,
                                          tr.recorder.tail_dicts(),
                                          trace_now=tr.now())

    def health(self) -> dict:
        """Liveness and post-mortem snapshot -- the ``GET /healthz`` body.

        LOCK-FREE on purpose: a wedged tick holds the engine lock, and
        health is exactly what is asked during a wedge.  Every field is a
        single-writer plain attribute.  ``healthy`` is False while a stall
        episode is open, while a started loop is dead, while RESTORING
        (with ``retry_after_s``, the back-off hint), and once stopped."""
        h = self._health
        t = self._thread
        loop_alive = None if t is None else t.is_alive()
        if h.stall_open:
            state = "wedged"
        elif self._restoring:
            # transient by construction: the probe backs off instead of
            # killing an engine that is adopting its journal
            state = "restoring"
        elif loop_alive is False and not self._draining \
                and not self._stop.is_set():
            state = "loop-dead"
        elif self._draining:
            state = "draining" if self._live else "stopped"
        elif self._live:
            state = "serving"
        else:
            state = "idle"
        now = self._clock()
        out = {"state": state,
               "healthy": state in ("idle", "serving", "draining"),
               "role": self.role,
               "live_requests": len(self._live),
               "queue_depth": self._pool.queue_depth,
               "loop_alive": loop_alive,
               "draining": self._draining,
               # degradation is the engine working: it stays healthy and
               # carries the level and the parked count
               "degraded": self._degrade_level,
               "preempted_requests": self._pool.preempted_count,
               "started_at": self._started_at,
               "uptime_s": max(0.0, now - self._started_at),
               "restoring": self._restoring}
        if self._restoring:
            out["retry_after_s"] = self._restore_retry_after_s
        if self._slo is not None:
            out["slo"] = self._slo.health_summary()
        out.update(h.snapshot())
        return out

    def _deadline_estimate_s(self, max_new_tokens: int,
                             prompt_len: int = 0) -> Optional[float]:
        """Seconds until a request admitted now would finish, from the
        observed mean tick time and the live token backlog; None until a
        tick was measured (never shed on a guess).  Each tick advances
        every slot a token, so the backlog drains at ``slots`` tokens a
        tick and the new request then needs ``max_new_tokens`` ticks.
        Under chunked prefill each not-yet-decoding prompt (this one
        included) adds its own ``ceil(len / C)`` ticks: chunks run one
        slot a tick."""
        if not self._timer.total:
            return None
        step_s = self._timer.step_time
        backlog = sum(r.max_new - len(r.tokens)
                      for r in self._live.values())
        ticks = backlog / self._pool.slots + float(max_new_tokens)
        chunk = self._pool.prefill_chunk_tokens
        if chunk:
            # QUEUED/PREFILLING, not first_t is None: a resubmitted victim
            # streamed tokens already but owes a full re-prefill
            pending = [prompt_len] + [
                r.prompt_len + len(r.tokens)
                for r in self._live.values()
                if r.state in (RequestState.QUEUED,
                               RequestState.PREFILLING)]
            ticks += sum(-(-p // chunk) for p in pending if p)
        return step_s * ticks

    # -- graceful teardown ----------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop admissions and finish every in-flight request.  True when
        drained, False when ``timeout_s`` (wall clock) passed first, in
        both drive modes, or when the background loop is dead (nothing
        would finish the requests, and a draining engine is not
        restarted).  Admissions stay closed after a timed-out drain; call
        again to keep waiting."""
        with self._lock:
            self._draining = True
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        if self._thread is None:
            while self.pump(1):
                if deadline is not None and time.monotonic() >= deadline:
                    return False
            return True
        self._wake.set()
        while True:
            with self._lock:
                if not self._live:
                    return True
            t = self._thread
            if t is None or not t.is_alive():
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    def shutdown(self, drain: bool = True) -> None:
        """Graceful stop: admissions off, in-flight requests finished
        (``drain=True``) or cancelled (``drain=False``), the loop thread
        joined (at most 10 s)."""
        with self._lock:
            self._draining = True
        if drain:
            self.drain()
        else:
            with self._lock:
                for rid in list(self._live):
                    self.cancel(rid)
        t = self._thread
        if t is not None:
            self._stop.set()
            self._wake.set()
            t.join(timeout=10.0)
            # only after a successful join: a wedged tick outlives the
            # join still holding the lock
            if not t.is_alive():
                with self._lock:
                    if self._thread is t:
                        self._thread = None
        with self._lock:
            # a drain that wedged left records live: close their trace
            # timelines so an export never ends a request mid-span
            for rid in list(self._live):
                trace.instant("req.aborted", rid=rid, reason="shutdown")
            # the final durability point: buffered records are drained
            # and the handle closed
            self._journal_flush()
            if self._journal is not None:
                self._journal.close()

    # -- tracing / flight recorder ---------------------------------------
    def start_trace(self, capacity: int = 4096,
                    deep_timing: bool = False) -> "trace.Tracer":
        """Build and install a process-wide tracer bound to this engine;
        returns it.  ``deep_timing`` makes the prefill and decode spans
        end at the device edge (a stream synchronize) and flags every span
        ``deep``.  Refuses to stack on an installed tracer."""
        t = trace.Tracer(capacity=capacity, deep_timing=deep_timing)
        trace.install(t)
        with self._lock:
            self._tracer = t
            self._trace_dropped_seen = 0
            self._compile_seen = None
        return t

    def stop_trace(self) -> Optional["trace.Tracer"]:
        """Uninstall the process-wide tracer (idempotent); returns it, its
        recorder still exportable through this engine.  Refuses to stop
        another engine's tracer."""
        t = trace.active()
        if t is not None and t is not self._tracer:
            raise PreconditionNotMetError(
                "the installed tracer is not this engine's: stop it from "
                "the engine that started it (a manually installed tracer "
                "is adopted by the first traced tick), or call "
                "serving.trace.uninstall() to stop tracing process-wide")
        trace.uninstall()
        return t

    def _trace_source(self) -> "trace.Tracer":
        tr = trace.active() or self._tracer
        if tr is None:
            raise PreconditionNotMetError(
                "no tracer was ever active on this engine: call "
                "start_trace() (or serving.trace.install) and run traffic "
                "before exporting a timeline")
        return tr

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Chrome/Perfetto trace-event JSON of the flight recorder (one
        track per request, one per tick phase); also written to ``path``
        when given.  Exports the active tracer, else the last one this
        engine saw."""
        return trace.export_chrome_trace(
            self._trace_source().recorder.snapshot(), path=path)

    def request_trace(self, request_id) -> dict:
        """One request's timeline as JSON-safe dicts -- the
        ``GET /debug/trace?rid=<id>`` body.  A string form of the id
        matches too; unknown ids raise :class:`NotFoundError`."""
        events = [e for e in self._trace_source().recorder.snapshot()
                  if e.rid is not None and (
                      e.rid == request_id or str(e.rid) == str(request_id))]
        if not events:
            raise NotFoundError(
                "no trace events recorded for request_id %r (unknown id, "
                "or its events were evicted by the ring -- see "
                "serving_trace_events_dropped_total)" % (request_id,))
        return {"request_id": request_id,
                "events": [e.to_dict() for e in events]}

    def flight_recorder(self) -> dict:
        """The flight recorder's state -- the ``GET /debug/flightrec``
        body: capacity, drops, the deep-timing flag, every retained
        event oldest first."""
        tr = self._trace_source()
        rec = tr.recorder
        return {"capacity": rec.capacity,
                "dropped": rec.dropped,
                "total_events": rec.total_events,
                "deep_timing": tr.deep,
                "events": [e.to_dict() for e in rec.snapshot()]}

    # -- passthroughs / introspection ------------------------------------
    def refresh_weights(self) -> None:
        """Weight swap between steps (``GenerationPool.refresh_weights``):
        call after changing the model's weights, in place or by replacing
        the tensors; later steps serve the new weights."""
        with self._lock:
            self._pool.refresh_weights()
            trace.instant("weights.refresh")

    def slo_snapshot(self) -> dict:
        """The SLO tracker's state with the ladder's -- the ``GET /slo``
        body.  ``PreconditionNotMetError`` without a tracker."""
        if self._slo is None:
            raise PreconditionNotMetError(
                "no SLO tracker is configured on this engine: pass "
                "slo=serving.slo.SLOTracker([...objectives...]) at "
                "construction to declare objectives")
        snap = self._slo.snapshot()
        snap["degradation"] = self.degradation_snapshot()
        return snap

    @property
    def slo(self):
        """The engine's :class:`~.slo.SLOTracker` (None when off)."""
        return self._slo

    def request_state(self, request_id) -> Optional[str]:
        """Lifecycle state of a live request; None if unknown/terminal."""
        with self._lock:
            rec = self._live.get(request_id)
            return rec.state if rec is not None else None

    def cache_stats(self) -> dict:
        """Live KV accounting (``GenerationPool.cache_stats``)."""
        with self._lock:
            return self._pool.cache_stats()

    def prefix_stats(self) -> dict:
        """Prefix-sharing and chunked-prefill accounting
        (``GenerationPool.prefix_stats``)."""
        with self._lock:
            return self._pool.prefix_stats()

    def resident_prefix_digest(self, since_epoch=None):
        """The chain-hash keys of the resident prefix blocks
        (``GenerationPool.prefix_digest``); None when sharing is off."""
        with self._lock:
            return self._pool.prefix_digest(since_epoch)

    def reset_prefix_stats(self) -> None:
        """Zero the pool's cumulative prefix and chunk counters (and the
        chunk counter's watermark with them)."""
        with self._lock:
            self._pool.reset_prefix_stats()
            self._chunks_seen = 0

    def spill_stats(self) -> dict:
        """Spill-tier accounting (``GenerationPool.spill_stats``)."""
        with self._lock:
            return self._pool.spill_stats()

    def acceptance_stats(self) -> Optional[dict]:
        """Speculative acceptance accounting
        (``SpeculativePool.acceptance_stats``); None on a plain pool."""
        if not hasattr(self._pool, "acceptance_stats"):
            return None
        with self._lock:
            return self._pool.acceptance_stats()

    def compile_counts(self) -> dict:
        """The pool's step keys (``GenerationPool.compile_counts``): a
        recovery leaves them unchanged."""
        with self._lock:
            return self._pool.compile_counts()

    def cost_version(self) -> int:
        """The pool's cost version (``GenerationPool.cost_version``)."""
        with self._lock:
            return self._pool.cost_version()

    def cost_report(self) -> dict:
        """Per-step-key cost attribution (``GenerationPool.cost_report`` /
        ``SpeculativePool.cost_report``): FLOPs, bytes accessed, the
        memory fields, the decode step's ``kv_cache_bytes`` and the
        ``derived`` per-token block behind the ``serving_step_*`` gauges.
        A read: it adds no key and synchronizes nothing."""
        with self._lock:
            return self._pool.cost_report()

    # -- multi-LoRA adapter management ---------------------------------------
    def load_adapter(self, idx: int, weights: dict) -> None:
        """Hot-load adapter ``idx``'s low-rank weights into the pool's bank
        under the engine lock: rows written in place, so no capture, and
        requests on other rows are untouched."""
        with self._lock:
            self._pool.load_adapter(idx, weights)

    def unload_adapter(self, idx: int) -> None:
        """Zero adapter ``idx``'s bank row; refuses (typed) while any live
        request is pinned to it."""
        with self._lock:
            self._pool.unload_adapter(idx)

    def has_adapter(self, idx: int) -> bool:
        """Whether ``idx`` is servable here: 0 (the base model) always; a
        nonzero id needs a bank with that row.  The fleet's router places
        adapter traffic by this."""
        try:
            self._pool._check_adapter(idx)
        except InvalidArgumentError:
            return False
        return True

    @property
    def lora_config(self):
        """The pool's bank geometry ``(n_adapters, rank)``, or None."""
        return self._pool.lora_config

    def release_device(self, blocking: bool = True) -> bool:
        """Give this engine's card memory back now: every captured graph
        is destroyed and the pool's caches and step buffers dropped
        (``GenerationPool.release_device``).  The engine serves nothing
        afterwards.  For a fleet's dead or retired engine, whose graphs
        the collector would otherwise free at a time of its choosing --
        possibly during another engine's capture.  With ``blocking=False``
        nothing happens while another thread holds the engine (a wedged
        tick may still be using the memory); returns whether it ran.
        Refused while the background loop runs: it would go on ticking
        the emptied pool."""
        if not self._lock.acquire(blocking):
            return False
        try:
            if self._thread is not None:
                raise PreconditionNotMetError(
                    "release_device() on an engine whose background loop "
                    "runs -- shutdown() it first")
            self._draining = True
            # the owner (a fleet) resumes these requests elsewhere
            self._live.clear()
            self._pool.release_device()
        finally:
            self._lock.release()
        return True

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

    @property
    def draining(self) -> bool:
        return self._draining
