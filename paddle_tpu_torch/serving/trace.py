"""Request-scoped tracing and the tick flight recorder (counterpart of
the reference's ``serving/trace.py``).

- :class:`FlightRecorder` is a bounded ring of :class:`TraceEvent`
  records.  Overflow evicts the oldest event and is counted
  (``dropped``, mirrored by the engine into
  ``serving_trace_events_dropped_total``), so a recorder can run for the
  life of an engine without growing.
- :class:`Tracer` is what instrumented code talks to: ``span(name)`` for
  the tick phases (``tick``, ``tick.admit``, ``tick.prefill``,
  ``tick.decode``, ``tick.sample``, ``tick.deliver``) and ``instant(name)``
  for the request lifecycle (``req.queued`` -> ``req.prefilling`` ->
  ``req.decoding`` -> a terminal mark), compiles, fault injections,
  recoveries, sheds, supervisor actions and the degradation ladder's
  ``sched.*`` decisions.

Tracing off costs one module-global ``is None`` test at each call site
(:func:`active`, :func:`instant`), the fault plane's pattern.

Deep timing.  A span times the host: a decode step replays its CUDA
graph and returns before the card finishes, so by default the
``tick.decode`` span brackets the launch and the ``tick.sample`` span the
token download that waits for the card.  ``Tracer(deep_timing=True)``
makes the pool synchronize the current CUDA stream at the end of the
prefill and decode spans, so those spans end at the device edge, and
every span the tracer records carries ``deep=True``; an export can never
pass launch time off as device time.

Export: :func:`export_chrome_trace` turns a recorder snapshot into
Chrome/Perfetto trace-event JSON -- one track per request and one per
tick phase -- through ``profiler.visual.chrome_trace_json``.  The engine
wraps it as ``ServingEngine.export_chrome_trace()`` and serves
``GET /debug/trace?rid=<id>`` and ``GET /debug/flightrec``; the
supervisor attaches the recorder's tail to ``EngineHealth`` on every
stall and restart.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import List, Optional

from ..core.errors import InvalidArgumentError, PreconditionNotMetError
from ..profiler.visual import chrome_trace_json

__all__ = ["TraceEvent", "FlightRecorder", "Tracer", "active", "install",
           "uninstall", "tracing", "instant", "export_chrome_trace",
           "to_chrome_events", "LIFECYCLE_EVENTS", "TERMINAL_EVENTS"]

# the request-lifecycle event names (engine-emitted): non-terminal marks
# OPEN a lifecycle phase on the request's export track; terminal marks
# close it.  Everything else is a tick phase span or a point event
# (compile / fault.injected / recovery / shed / stall / restart / the
# ladder's sched.* decisions).
LIFECYCLE_EVENTS = {
    "req.queued": "QUEUED",
    "req.prefilling": "PREFILLING",
    "req.decoding": "DECODING",
}
TERMINAL_EVENTS = frozenset((
    "req.done", "req.cancelled", "req.expired", "req.failed",
    "req.aborted",
))


class TraceEvent:
    """One recorded event.  ``dur_s`` is None for instant marks; spans
    carry their duration plus the ``deep`` honesty flag of the tracer
    that timed them.  ``rid`` ties an event to a request (None for
    engine-/tick-scoped events); ``meta`` is a small JSON-safe dict."""

    __slots__ = ("ts", "name", "rid", "dur_s", "deep", "meta")

    def __init__(self, ts, name, rid=None, dur_s=None, deep=False,
                 meta=None):
        self.ts = ts
        self.name = name
        self.rid = rid
        self.dur_s = dur_s
        self.deep = deep
        self.meta = meta

    def to_dict(self) -> dict:
        out = {"ts": self.ts, "name": self.name}
        if self.rid is not None:
            out["rid"] = self.rid
        if self.dur_s is not None:
            out["dur_s"] = self.dur_s
            out["deep"] = bool(self.deep)
        if self.meta:
            out["meta"] = self.meta
        return out

    def __repr__(self):  # debugging/pytest -v readability
        return "TraceEvent(%r, ts=%.6f%s%s)" % (
            self.name, self.ts,
            "" if self.rid is None else ", rid=%r" % (self.rid,),
            "" if self.dur_s is None else ", dur_s=%.6f" % self.dur_s)


class FlightRecorder:
    """Bounded ring buffer of trace events.

    ``capacity`` bounds memory whatever the traffic; overflow evicts the
    OLDEST event (a flight recorder keeps the moments before the crash,
    not the takeoff) and is counted in ``dropped`` so eviction is
    observable, never silent.  Lock-light: one short mutex around the
    deque append — no allocation beyond the event itself, no host
    sync — cheap enough for the tick path when tracing is on, and the
    whole structure is simply never touched when tracing is off."""

    def __init__(self, capacity: int = 4096):
        if int(capacity) < 1:
            raise InvalidArgumentError(
                "FlightRecorder needs capacity >= 1, got %r"
                % (capacity,))
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0

    def append(self, event: TraceEvent) -> None:
        with self._lock:
            self._buf.append(event)
            self._total += 1

    @property
    def total_events(self) -> int:
        """Events ever appended (retained + dropped)."""
        return self._total

    @property
    def dropped(self) -> int:
        """Events evicted by ring overflow — the engine mirrors this
        into ``serving_trace_events_dropped_total``."""
        with self._lock:
            return self._total - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> List[TraceEvent]:
        """The retained events, oldest first (a copy)."""
        with self._lock:
            return list(self._buf)

    def tail_dicts(self, n: int = 64) -> List[dict]:
        """The last ``n`` events as JSON-safe dicts — the post-mortem
        dump the supervisor attaches to ``EngineHealth``."""
        with self._lock:
            evs = list(self._buf)[-int(n):]
        return [e.to_dict() for e in evs]


class _Span:
    """The span context manager ``Tracer.span`` hands out: times the
    block on the tracer's clock and records ONE complete event at exit
    (start timestamp + duration), so a span costs two clock reads and
    one ring append."""

    __slots__ = ("_tr", "_name", "_rid", "_meta", "_t0")

    def __init__(self, tr, name, rid, meta):
        self._tr = tr
        self._name = name
        self._rid = rid
        self._meta = meta

    def __enter__(self):
        self._t0 = self._tr._clock()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr._emit(TraceEvent(self._t0, self._name, self._rid,
                            tr._clock() - self._t0, tr.deep,
                            self._meta or None))
        return False


class Tracer:
    """The emitter instrumented code talks to; owns one
    :class:`FlightRecorder`.

    ``deep_timing=True`` is the opt-in device-attribution mode: the
    pool synchronizes the current CUDA stream at the end of its prefill
    and decode spans, and every span this tracer records carries
    ``deep=True`` so the export can never pass launch time off as device
    time.
    ``clock`` defaults to ``time.perf_counter`` — ALL trace timestamps
    live in this one clock domain, so cross-event ordering is
    meaningful even on engines driven by an injected deadline clock."""

    def __init__(self, capacity: int = 4096, deep_timing: bool = False,
                 clock=None):
        self.recorder = FlightRecorder(capacity)
        self.deep = bool(deep_timing)
        self._clock = clock if clock is not None else time.perf_counter
        self._ticks = 0

    def now(self) -> float:
        """A reading of the TRACER's clock — the domain every event
        timestamp lives in.  Post-mortem dumps stamp this alongside the
        engine-clock ``at`` so consumers can align the dumped events'
        ``ts`` with the dump moment across the two clock domains."""
        return self._clock()

    @property
    def tick(self) -> int:
        """The CURRENT tick number (0 before the first traced tick) —
        the join key the structured log (serving/log.py) stamps on
        every event so log lines and flight-recorder timelines align
        by number."""
        return self._ticks

    def next_tick(self) -> int:
        """The engine's tick sequence number under THIS tracer (restarts
        at 1 with a fresh tracer — tick numbering is a trace-lifetime
        concept).  Single-writer by construction: only the ticking
        thread calls it, under the engine lock — the recorder behind
        ``_emit`` keeps its own mutex for the multi-writer side."""
        self._ticks += 1
        return self._ticks

    def instant(self, name: str, rid=None, **meta) -> None:
        """Record a point event (lifecycle transition, compile, fault
        injection, recovery, shed, stall, restart)."""
        self._emit(TraceEvent(self._clock(), name, rid, None, self.deep,
                              meta or None))

    def span(self, name: str, rid=None, **meta) -> _Span:
        """Context manager timing one tick phase (or any block)."""
        return _Span(self, name, rid, meta)

    def _emit(self, event: TraceEvent) -> None:
        self.recorder.append(event)


# -- module-level activation (the fault-plane pattern) --------------------
# ONE global tracer: the hot-path cost of tracing-off is a single
# is-None test in instant()/active(), nothing else.
_TRACER: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is off."""
    return _TRACER


def install(tracer: Tracer) -> Tracer:
    """Activate ``tracer`` process-wide; returns it.  Refuses to stack —
    two tracers would split one engine's timeline across two rings."""
    global _TRACER
    if _TRACER is not None:
        raise PreconditionNotMetError(
            "a Tracer is already installed; uninstall() it first (one "
            "timeline per process — traces do not compose across "
            "tracers)")
    _TRACER = tracer
    return tracer


def uninstall() -> None:
    """Deactivate tracing (idempotent).  The last tracer's recorder
    stays readable — the engine keeps a reference for export and
    post-mortem dumps."""
    global _TRACER
    _TRACER = None


@contextlib.contextmanager
def tracing(tracer: Tracer):
    """``with trace.tracing(t):`` — install for the block, always
    uninstall after, so a failing test cannot leak a tracer into the
    next one."""
    install(tracer)
    try:
        yield tracer
    finally:
        uninstall()


def instant(name: str, rid=None, **meta) -> None:
    """The module-level emission seam call sites use: a no-op unless a
    tracer is installed."""
    t = _TRACER
    if t is not None:
        t.instant(name, rid=rid, **meta)


# -- Chrome/Perfetto export ----------------------------------------------

def to_chrome_events(events: List[TraceEvent]) -> List[dict]:
    """Transform a recorder snapshot into Chrome trace-event dicts.

    Layout: pid 0 holds one track (tid) per tick-phase/point-event name;
    pid 1 holds one track per request.  Request lifecycle marks become
    complete ("X") spans closed by the NEXT transition — the terminal
    mark closes the last one and lands as its own instant — so a
    drained/shut-down engine exports timelines with no open spans; a
    request still live at export time gets its trailing span flagged
    ``"open": true`` instead of silently truncated.  Every phase span
    carries its ``deep`` honesty flag in ``args``.  Events are sorted
    by timestamp per track (monotonic within every (pid, tid))."""
    evs = sorted(events, key=lambda e: e.ts)
    out: List[dict] = []
    out.append({"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": "tick phases"}})
    out.append({"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "requests"}})
    phase_tids: dict = {}

    def phase_tid(name):
        tid = phase_tids.get(name)
        if tid is None:
            tid = len(phase_tids)
            phase_tids[name] = tid
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        return tid

    req_tids: dict = {}

    def req_tid(rid_key):
        tid = req_tids.get(rid_key)
        if tid is None:
            tid = len(req_tids)
            req_tids[rid_key] = tid
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid,
                        "args": {"name": "request %s" % (rid_key,)}})
        return tid

    by_rid: dict = {}
    for e in evs:
        if e.name in LIFECYCLE_EVENTS or e.name in TERMINAL_EVENTS:
            by_rid.setdefault(str(e.rid), []).append(e)
            continue
        args = dict(e.meta or {})
        if e.rid is not None:
            args["rid"] = e.rid if isinstance(e.rid, (str, int, float)) \
                else str(e.rid)
        if e.dur_s is not None:
            args["deep"] = bool(e.deep)
            out.append({"name": e.name, "ph": "X", "cat": "phase",
                        "pid": 0, "tid": phase_tid(e.name),
                        "ts": e.ts * 1e6,
                        "dur": max(e.dur_s, 0.0) * 1e6, "args": args})
        else:
            out.append({"name": e.name, "ph": "i", "s": "g",
                        "cat": "event", "pid": 0,
                        "tid": phase_tid(e.name), "ts": e.ts * 1e6,
                        "args": args})
    end_ts = evs[-1].ts if evs else 0.0
    for rid_key, revs in by_rid.items():
        tid = req_tid(rid_key)
        for i, ev in enumerate(revs):
            nxt = revs[i + 1] if i + 1 < len(revs) else None
            args = dict(ev.meta or {})
            if ev.name in TERMINAL_EVENTS:
                out.append({"name": ev.name.split(".", 1)[1].upper(),
                            "ph": "i", "s": "t", "cat": "lifecycle",
                            "pid": 1, "tid": tid, "ts": ev.ts * 1e6,
                            "args": args})
                continue
            close = end_ts if nxt is None else nxt.ts
            if nxt is None:
                # no terminal mark reached the recorder: the request is
                # still live (or its terminal was evicted) — say so
                # rather than faking a closed span
                args["open"] = True
            out.append({"name": LIFECYCLE_EVENTS[ev.name], "ph": "X",
                        "cat": "lifecycle", "pid": 1, "tid": tid,
                        "ts": ev.ts * 1e6,
                        "dur": max(close - ev.ts, 0.0) * 1e6,
                        "args": args})
    # monotonic per track: metadata ("M", no ts) sorts first
    out.sort(key=lambda d: (d["pid"], d["tid"], d.get("ts", -1.0)))
    return out


def export_chrome_trace(events: List[TraceEvent],
                        path: Optional[str] = None) -> str:
    """Serialize ``events`` as Chrome trace-event JSON (returned; also
    written to ``path`` when given) through the shared
    ``profiler.visual.chrome_trace_json`` writer — the same format the
    training-side op-table export emits, so one viewer reads both."""
    return chrome_trace_json(to_chrome_events(events), path=path)
