"""Tick supervision: the engine's health record and its watchdog
(counterpart of the reference's ``serving/supervisor.py``, without its
``FleetSupervisor``, which waits for the fleet).

The background loop has two failure shapes it cannot report itself: the
thread DIES (an exception escaped the tick's recovery) and the tick
WEDGES (a step that hangs without raising, holding the engine lock).
:class:`Supervisor` watches from its own thread without the engine lock:

- dead loop: the engine's thread exists but is not alive while the
  engine was neither stopped nor drained -- the supervisor restarts it
  (``ServingEngine.restart_loop``), counted in
  ``serving_engine_restarts_total``;
- stalled tick: a tick started more than ``stall_timeout_s`` ago and has
  not finished -- the supervisor opens a STALL episode (counted once in
  ``serving_ticks_stalled_total``, closed when the tick finishes), which
  makes ``health()`` and ``GET /healthz`` unhealthy meanwhile.

:class:`EngineHealth` is the lock-free heartbeat behind
``ServingEngine.health()``: single-writer plain attributes, read without
a lock on purpose, since health is asked exactly while a tick is wedged.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..core.errors import InvalidArgumentError
from . import trace

__all__ = ["EngineHealth", "Supervisor"]


class EngineHealth:
    """Mutable heartbeat/post-mortem record for one engine.

    Plain attributes, no lock: every field is written by a single
    writer (the ticking thread under the engine lock, or the supervisor
    for ``stall_open``/``stalls``) and read lock-free by ``health()``
    and the watchdog — a torn read costs at worst one poll interval of
    staleness, never a deadlock against a wedged tick."""

    def __init__(self):
        self.tick_started_at: Optional[float] = None
        self.tick_finished_at: Optional[float] = None
        self.ticks_total = 0
        self.last_error: Optional[str] = None
        self.last_error_at: Optional[float] = None
        self.last_error_kind: Optional[str] = None
        self.restarts = 0
        self.recoveries = 0
        self.requests_recovered = 0
        self.restores = 0
        self.last_restore_s: Optional[float] = None
        self.stalls = 0
        self.stall_open = False
        # post-mortem timeline: the flight recorder's tail, attached by
        # the supervisor on stall/restart and by the dying loop itself
        # ({"reason", "at", "events"} — already JSON-safe dicts)
        self.flight_dump: Optional[dict] = None

    # -- written by the ticking thread (under the engine lock) -----------
    def note_tick_start(self, now: float) -> None:
        self.tick_started_at = now

    def note_tick_end(self, now: float) -> None:
        self.tick_finished_at = now
        self.ticks_total += 1
        self.stall_open = False  # a finished tick closes any episode

    def note_error(self, now: float, exc: BaseException,
                   kind: str) -> None:
        """Record the last failure for post-mortems: the step error a
        recovery handled, or the loop-killing error ``_loop`` caught —
        either way ``health()`` carries WHAT and WHEN, so a parked loop
        is never a debugger-only mystery."""
        self.last_error = "%s: %s" % (type(exc).__name__, str(exc)[:300])
        self.last_error_at = now
        self.last_error_kind = kind

    def note_recovery(self, resubmitted: int) -> None:
        self.recoveries += 1
        self.requests_recovered += resubmitted

    def note_restore(self, duration_s: float) -> None:
        """A journal restore completed on this engine: the count and the
        last restore's wall time ride every health snapshot."""
        self.restores += 1
        self.last_restore_s = duration_s

    def note_restart(self, now: float) -> None:
        self.restarts += 1
        self.stall_open = False  # the wedged loop is gone; fresh start

    def note_flight_dump(self, now: float, reason: str, events: list,
                         trace_now: Optional[float] = None) -> None:
        """Attach the flight recorder's tail (JSON-safe event dicts):
        every stall, watchdog restart, and loop-killing error ships the
        timeline that led up to it — one field write, so the lock-free
        read discipline holds (a torn read sees the previous dump,
        never a mix).  ``at`` is in the ENGINE clock domain (consistent
        with every other timestamp in this snapshot); the events' ``ts``
        live in the TRACER's clock, so ``trace_now`` — the tracer clock
        at dump time — is stamped alongside to let a consumer align
        the two."""
        self.flight_dump = {"reason": reason, "at": now,
                            "trace_now": trace_now, "events": events}

    # -- written by the supervisor ---------------------------------------
    def open_stall(self) -> bool:
        """Open a stall episode; True only on the OPENING observation
        (the caller counts episodes, not polls)."""
        if self.stall_open:
            return False
        self.stall_open = True
        self.stalls += 1
        return True

    def tick_busy(self) -> bool:
        """A tick started and has not finished."""
        return self.tick_started_at is not None and (
            self.tick_finished_at is None
            or self.tick_finished_at < self.tick_started_at)

    def snapshot(self) -> dict:
        return {
            "ticks_total": self.ticks_total,
            "last_tick_started_at": self.tick_started_at,
            "last_tick_finished_at": self.tick_finished_at,
            "last_error": self.last_error,
            "last_error_at": self.last_error_at,
            "last_error_kind": self.last_error_kind,
            "restarts": self.restarts,
            "recoveries": self.recoveries,
            "requests_recovered": self.requests_recovered,
            "restores": self.restores,
            "last_restore_s": self.last_restore_s,
            "ticks_stalled": self.stalls,
            "flight_dump": self.flight_dump,
        }


class Supervisor:
    """Watchdog over one :class:`~.engine.ServingEngine`.

    ``check_once()`` is the whole policy — one sweep, returns the list
    of actions taken (``"stall-detected"``, ``"loop-restarted"``) so
    tests drive supervision deterministically with an injected clock.
    ``start()`` runs the same sweep from an owned daemon thread every
    ``poll_interval_s`` for real serving.  The supervisor NEVER takes
    the engine lock: detection reads the lock-free health record, and
    the only mutation it performs — restarting a DEAD loop — goes
    through ``restart_loop()``, which can take the lock safely because
    a dead thread by definition is not holding it."""

    def __init__(self, engine, stall_timeout_s: float = 5.0,
                 poll_interval_s: Optional[float] = None, clock=None):
        if not float(stall_timeout_s) > 0.0:
            raise InvalidArgumentError(
                "stall_timeout_s must be > 0, got %r" % (stall_timeout_s,))
        self.engine = engine
        self.stall_timeout_s = float(stall_timeout_s)
        self.poll_interval_s = (max(0.005, self.stall_timeout_s / 4.0)
                                if poll_interval_s is None
                                else float(poll_interval_s))
        # default to the ENGINE's clock, not time.monotonic: heartbeat
        # timestamps are stamped in the engine's clock domain, and
        # stall math across two time bases would misfire (an engine
        # with an injected test clock would look permanently wedged)
        self._clock = clock if clock is not None \
            else getattr(engine, "_clock", time.monotonic)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- the one supervision sweep ---------------------------------------
    def check_once(self) -> List[str]:
        """Detect a stalled tick and/or a dead loop; return the actions
        taken this sweep (possibly empty)."""
        actions: List[str] = []
        eng = self.engine
        health = eng._health
        now = self._clock()
        if health.tick_busy() and \
                now - health.tick_started_at >= self.stall_timeout_s:
            if health.open_stall():
                eng._note_stall()
                actions.append("stall-detected")
        thread = eng._thread
        if thread is not None and not thread.is_alive() \
                and not eng._stop.is_set() and not eng.draining:
            if eng.restart_loop():
                actions.append("loop-restarted")
        if actions:
            # every supervised incident ships its own timeline: dump
            # the flight recorder's tail into the health record the
            # moment a stall opens or a dead loop is restarted, so
            # GET /healthz IS the post-mortem (no-op when no tracer
            # was ever active on the engine)
            tr = trace.active() or getattr(eng, "_tracer", None)
            if tr is not None:
                health.note_flight_dump(now, "+".join(actions),
                                        tr.recorder.tail_dicts(),
                                        trace_now=tr.now())
        return actions

    # -- owned watchdog thread -------------------------------------------
    def start(self) -> "Supervisor":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="serving-engine-supervisor",
                    daemon=True)
                self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.check_once()
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
                self._thread = None

    def is_running(self) -> bool:
        return self._thread is not None
