"""Deterministic fault injection for the serving stack (counterpart of
the reference's ``serving/faults.py``).

NAMED injection points sit at the real failure seams, driven by scripted
schedules or a seeded chaos mode:

- ``pool.step``        -- entry of the batched decode step
- ``pool.prefill``     -- the refill's bucketed prefill and each chunk
- ``pool.alloc_blocks``-- the paged allocation at admission
- ``weights.refresh``  -- the weight-refresh path
- ``stream.deliver``   -- per-token delivery into a ResponseStream
- ``http.write``       -- the per-token ndjson socket write
- ``journal.append``   -- the request journal's record write
- ``spill.write``      -- the disk spill tier's K/V file write
- ``xfer.write``       -- the K/V hand-off's transfer-file write

The last three fire at the reference's call sites (the journal writer's
append, the PTKV writer of a preemption spill and of ``export_kv``), so
one chaos seed injects at the same hits in both packages.

The plane is OFF by default: ``fire(point)`` is one module-global ``is
None`` test -- no allocation, no lock, no device work.  Injected faults
are typed: :class:`TransientInjectedFault` is retryable (recovery
resubmits the victims), :class:`PermanentInjectedFault` is not, and
:func:`classify_error` extends that vocabulary to real exceptions so
recovery treats an injected fault and a real one alike.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.errors import (InvalidArgumentError, NotFoundError,
                           PreconditionNotMetError)
from . import trace

__all__ = ["POINTS", "FaultSpec", "FaultPlane", "InjectedFaultError",
           "TransientInjectedFault", "PermanentInjectedFault",
           "classify_error", "fire", "install", "uninstall", "active",
           "injected"]

# the canonical injection-point names; FaultSpec refuses anything else
# so a typo'd point can never silently never-fire
POINTS = (
    "pool.step",
    "pool.prefill",
    "pool.alloc_blocks",
    "weights.refresh",
    "stream.deliver",
    "http.write",
    "journal.append",
    "spill.write",
    "xfer.write",
)
_POINT_SET = frozenset(POINTS)


class InjectedFaultError(Exception):
    """Base of the injected-fault family.  ``point`` names the seam,
    ``hit`` the 1-based fire count at which the fault triggered."""

    transient = True

    def __init__(self, message: str = "", point: str = "?", hit: int = 0):
        super().__init__(message or "injected fault at %s (hit %d)"
                         % (point, hit))
        self.point = point
        self.hit = hit


class TransientInjectedFault(InjectedFaultError):
    """Retryable: models a transport hiccup / allocator race — the
    engine's recovery path re-prefills and continues the victims."""

    transient = True


class PermanentInjectedFault(InjectedFaultError):
    """Not retryable: models a poisoned request / corrupted weights —
    recovery fails the victims immediately instead of burning retries."""

    transient = False


def classify_error(exc: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` — the retry classification the
    engine's recovery path applies to a failed step.

    An explicit ``transient`` attribute (the injected-fault family, or
    any cooperating error type) wins.  Caller-bug errors — invalid
    arguments, unknown ids, precondition violations — are PERMANENT:
    replaying the same inputs cannot heal them, and retrying would burn
    the budget hiding the bug.  Everything else defaults to TRANSIENT,
    because the step's real-world failure modes (transport resets,
    device OOM churn, runtime hiccups) are exactly the ones a rebuilt
    pool survives."""
    t = getattr(exc, "transient", None)
    if t is not None:
        return "transient" if t else "permanent"
    if isinstance(exc, (InvalidArgumentError, NotFoundError,
                        PreconditionNotMetError)):
        return "permanent"
    return "transient"


class FaultSpec:
    """One scripted fault: at ``point``, skip the first ``after`` hits,
    then fire on each of the next ``times`` hits — sleeping ``delay_s``
    (a wedge) and/or raising ``error`` (an exception instance, or a
    class instantiated with the point/hit context)."""

    def __init__(self, point: str, error=None, delay_s: float = 0.0,
                 after: int = 0, times: int = 1):
        if point not in _POINT_SET:
            raise InvalidArgumentError(
                "unknown fault point %r; the seams are %s"
                % (point, ", ".join(POINTS)))
        if error is None and not delay_s > 0.0:
            raise InvalidArgumentError(
                "a FaultSpec needs an error to raise and/or a positive "
                "delay_s to sleep; got neither")
        if int(times) < 1 or int(after) < 0:
            raise InvalidArgumentError(
                "need times >= 1 and after >= 0, got times=%r after=%r"
                % (times, after))
        self.point = point
        self.error = error
        self.delay_s = float(delay_s)
        self.after = int(after)
        self.times = int(times)
        self.fired = 0  # mutated by the owning plane, under its lock

    def _matches(self, hit: int) -> bool:
        return hit > self.after and self.fired < self.times

    def _make_error(self, hit: int) -> Optional[BaseException]:
        if self.error is None:
            return None
        if isinstance(self.error, BaseException):
            return self.error
        try:
            return self.error(point=self.point, hit=hit)
        except TypeError:
            # a plain exception class (OSError subclasses etc.) that
            # does not take the injection context — still injectable
            return self.error("injected fault at %s (hit %d)"
                              % (self.point, hit))


class FaultPlane:
    """A set of scripted :class:`FaultSpec` schedules plus an optional
    seeded chaos mode (each ``fire`` at a chaos point raises a
    :class:`TransientInjectedFault` with probability ``chaos_p``,
    driven by ``random.Random(chaos_seed)`` — fully deterministic for
    a fixed seed and fire sequence).  ``max_faults`` caps the TOTAL
    faults the plane will ever raise, so a chaos run is guaranteed to
    stop interfering and let traffic drain.

    ``hits`` (point -> fire count) and ``injected`` (the log of
    ``(point, hit, error-class-name)`` triples) are the assertion
    surface for tests.  Thread-safe: one lock guards all accounting —
    delay sleeps happen OUTSIDE it so a wedge never blocks another
    thread's bookkeeping."""

    def __init__(self, specs: Sequence[FaultSpec] = (),
                 chaos_seed: Optional[int] = None, chaos_p: float = 0.0,
                 chaos_points: Optional[Sequence[str]] = None,
                 max_faults: Optional[int] = None):
        if chaos_p and not 0.0 < chaos_p <= 1.0:
            raise InvalidArgumentError(
                "chaos_p must be in (0, 1], got %r" % (chaos_p,))
        if chaos_p and chaos_seed is None:
            raise InvalidArgumentError(
                "chaos mode needs chaos_seed: an unseeded chaos run "
                "cannot be replayed, which defeats the harness")
        bad = [p for p in (chaos_points or ()) if p not in _POINT_SET]
        if bad:
            raise InvalidArgumentError(
                "unknown chaos points %r; the seams are %s"
                % (bad, ", ".join(POINTS)))
        self._specs: Dict[str, List[FaultSpec]] = {}
        for spec in specs:
            self._specs.setdefault(spec.point, []).append(spec)
        self._chaos_p = float(chaos_p)
        self._chaos_points = frozenset(chaos_points or POINTS)
        self._rng = random.Random(chaos_seed)
        self._max_faults = None if max_faults is None else int(max_faults)
        self._lock = threading.Lock()
        self.hits: Dict[str, int] = {}
        self.injected: List[Tuple[str, int, str]] = []

    def fire(self, point: str) -> None:
        """Count one pass through ``point``; sleep and/or raise per the
        schedules.  Called from the hot path ONLY when a plane is
        installed."""
        delay = 0.0
        err: Optional[BaseException] = None
        with self._lock:
            hit = self.hits.get(point, 0) + 1
            self.hits[point] = hit
            budget_left = self._max_faults is None \
                or len(self.injected) < self._max_faults
            for spec in self._specs.get(point, ()):
                if not budget_left or not spec._matches(hit):
                    continue
                spec.fired += 1
                delay = max(delay, spec.delay_s)
                if err is None:
                    err = spec._make_error(hit)
            if err is None and budget_left and self._chaos_p \
                    and point in self._chaos_points \
                    and self._rng.random() < self._chaos_p:
                err = TransientInjectedFault(point=point, hit=hit)
            if err is not None or delay > 0.0:
                self.injected.append(
                    (point, hit,
                     type(err).__name__ if err is not None else "delay"))
        if err is not None or delay > 0.0:
            # the flight recorder sees every injection the moment it
            # fires (a no-op when tracing is off), so a post-mortem
            # timeline carries its own fault schedule
            trace.instant(
                "fault.injected", point=point, hit=hit,
                error=(type(err).__name__ if err is not None
                       else "delay"),
                delay_s=(delay if delay > 0.0 else None))
        if delay > 0.0:
            time.sleep(delay)
        if err is not None:
            raise err

    @property
    def fault_count(self) -> int:
        """Total faults (raises + delays) this plane has injected."""
        return len(self.injected)


# -- module-level activation ---------------------------------------------
# ONE global plane: `fire(point)` is the only thing on the hot path, and
# with no plane installed it is a single is-None test.
_PLANE: Optional[FaultPlane] = None


def fire(point: str) -> None:
    """The injection seam call sites use.  No-op unless a plane is
    installed; the installed plane may sleep (wedge) or raise."""
    plane = _PLANE
    if plane is not None:
        plane.fire(point)


def install(plane: FaultPlane) -> FaultPlane:
    """Activate ``plane`` process-wide; returns it.  Refuses to stack —
    two planes would make every schedule's hit counts meaningless."""
    global _PLANE
    if _PLANE is not None:
        raise PreconditionNotMetError(
            "a FaultPlane is already installed; uninstall() it first "
            "(schedules do not compose across planes)")
    _PLANE = plane
    return plane


def uninstall() -> None:
    """Deactivate fault injection (idempotent)."""
    global _PLANE
    _PLANE = None


def active() -> Optional[FaultPlane]:
    """The installed plane, or None when injection is off."""
    return _PLANE


@contextlib.contextmanager
def injected(plane: FaultPlane):
    """``with faults.injected(plane):`` — install for the block, always
    uninstall after, so a failing test cannot leak faults into the next
    one."""
    install(plane)
    try:
        yield plane
    finally:
        uninstall()
