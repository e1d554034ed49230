"""SLO tracking: declarative objectives and multi-window burn-rate
alerts (counterpart of the reference's ``serving/slo.py``).

An :class:`Objective` declares one promise (TTFT p95 under a threshold,
inter-token p95 under a threshold, availability above a floor);
:class:`SLOTracker` evaluates it over rolling TICK windows:

- burn rate = (bad fraction in the window) / (error budget), the budget
  being ``1 - target``;
- a FAST window (default 5 ticks) and a SLOW window (default 60): the
  alert is active only while BOTH burn at or above ``burn_threshold``,
  so it flips within ticks of an incident, a single bad tick does not
  page, and the fast window clears it within ticks of the end.

The engine feeds it from the real path: ``_on_token`` reports each TTFT
and inter-token observation, every terminal reports its state, and each
tick rolls the windows.  Without a tracker (``ServingEngine(slo=None)``)
each seam costs one ``is None`` test.  The tracker binds gauges into the
engine's registry (``serving_slo_<name>_burn_rate_fast`` / ``_slow``,
``..._alert_active``, ``..._budget_remaining``); ``snapshot()`` backs
``GET /slo``; ``health_summary()`` rides ``ServingEngine.health()``;
alert flips land in the flight recorder and the structured log.
"""
from __future__ import annotations

import re
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..core.errors import InvalidArgumentError
from . import log as slog
from . import trace

__all__ = ["Objective", "SLOTracker", "DEFAULT_OBJECTIVES"]

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# the objective vocabulary: what is observed and what "bad" means
_KINDS = ("ttft", "inter_token", "availability")


class Objective:
    """One declarative serving promise.

    ``kind``:
    - ``"ttft"`` / ``"inter_token"``: a latency promise — an
      observation is BAD when it exceeds ``threshold_s``; ``target``
      is the fraction that must be good (``target=0.95`` reads "p95 of
      TTFT stays under ``threshold_s``").
    - ``"availability"``: a terminal-state promise — a request is BAD
      when it finalizes in one of ``bad_states`` (default: FAILED;
      deliberately not CANCELLED/EXPIRED, which are caller/deadline
      decisions, not the engine breaking its promise — pass
      ``bad_states=("FAILED", "EXPIRED")`` to promise deadlines too).

    The error budget is ``1 - target``: the fraction of bad outcomes
    the objective tolerates before its burn rate reaches 1.0.
    """

    __slots__ = ("name", "kind", "target", "threshold_s", "bad_states",
                 "description")

    def __init__(self, name: str, kind: str, target: float,
                 threshold_s: Optional[float] = None,
                 bad_states: Sequence[str] = ("FAILED",),
                 description: str = ""):
        if not _NAME_RE.match(name):
            raise InvalidArgumentError(
                "objective name %r must be a prometheus-safe identifier "
                "([a-zA-Z_][a-zA-Z0-9_]*): it becomes part of the "
                "exported gauge names" % (name,))
        if kind not in _KINDS:
            raise InvalidArgumentError(
                "objective kind must be one of %s, got %r"
                % (", ".join(_KINDS), kind))
        if not 0.0 < float(target) < 1.0:
            # target 1.0 would make the error budget zero and every
            # burn rate infinite; 0 would never alert
            raise InvalidArgumentError(
                "target must be in (0, 1) (e.g. 0.95 = '95%% of events "
                "good'), got %r" % (target,))
        if kind != "availability":
            if threshold_s is None or not float(threshold_s) > 0.0:
                raise InvalidArgumentError(
                    "latency objective %r (kind %r) needs threshold_s "
                    "> 0, got %r" % (name, kind, threshold_s))
            threshold_s = float(threshold_s)
        elif threshold_s is not None:
            raise InvalidArgumentError(
                "availability objective %r takes no threshold_s "
                "(badness is the terminal state, not a latency)"
                % (name,))
        if isinstance(bad_states, str):
            # a bare string IS a Sequence[str]: frozenset('FAILED')
            # would become {'F','A',...}, silently matching nothing —
            # the objective would never alert during a real outage
            raise InvalidArgumentError(
                "bad_states must be a sequence of state names, got the "
                "bare string %r — write bad_states=(%r,)"
                % (bad_states, bad_states))
        bad_states = tuple(bad_states)
        unknown = [s for s in bad_states
                   if s not in ("DONE", "CANCELLED", "EXPIRED",
                                "FAILED")]
        if unknown:
            raise InvalidArgumentError(
                "unknown terminal state(s) %r in bad_states; the "
                "request lifecycle ends in DONE, CANCELLED, EXPIRED "
                "or FAILED" % (unknown,))
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.threshold_s = threshold_s
        self.bad_states = frozenset(bad_states)
        self.description = description

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target


def DEFAULT_OBJECTIVES(ttft_p95_s: float = 1.0,
                       inter_token_p95_s: float = 0.25,
                       availability: float = 0.99) -> List[Objective]:
    """The standard serving objective set:
    TTFT p95, inter-token p95, availability — thresholds are
    deployment-specific, so they are arguments, not constants."""
    return [
        Objective("ttft_p95", "ttft", 0.95, threshold_s=ttft_p95_s,
                  description="95%% of first tokens within %gs"
                  % ttft_p95_s),
        Objective("inter_token_p95", "inter_token", 0.95,
                  threshold_s=inter_token_p95_s,
                  description="95%% of token gaps within %gs"
                  % inter_token_p95_s),
        Objective("availability", "availability", availability,
                  description="fraction of requests that do not FAIL"),
    ]


class _ObjectiveState:
    """Rolling-window accounting for one objective.

    Single-writer (the ticking thread, under the engine lock); read
    lock-free by ``health()``/``snapshot()`` — every exported field is
    a plain attribute, so a torn read costs staleness, never a hang
    (the ``EngineHealth`` discipline)."""

    __slots__ = ("objective", "cur_good", "cur_bad", "window",
                 "slow_good", "slow_bad", "fast_good", "fast_bad",
                 "fast_burn", "slow_burn",
                 "alert_active", "alerts_fired", "total_good",
                 "total_bad")

    def __init__(self, objective: Objective, slow_window: int):
        self.objective = objective
        self.cur_good = 0
        self.cur_bad = 0
        # per-tick (good, bad) pairs, newest right; maxlen evicts the
        # tick that just left the slow window
        self.window: deque = deque(maxlen=slow_window)
        self.slow_good = 0
        self.slow_bad = 0
        self.fast_good = 0
        self.fast_bad = 0
        self.fast_burn = 0.0
        self.slow_burn = 0.0
        self.alert_active = False
        self.alerts_fired = 0
        self.total_good = 0
        self.total_bad = 0

    def observe(self, bad: bool) -> None:
        if bad:
            self.cur_bad += 1
            self.total_bad += 1
        else:
            self.cur_good += 1
            self.total_good += 1

    def roll(self, fast_window: int, burn_threshold: float) -> Optional[bool]:
        """Close the current tick's bucket and re-evaluate both
        windows; returns the new alert state when it FLIPPED, else
        None.

        Both windows carry RUNNING sums — the tick path (idle ticks
        included) does O(1) arithmetic and one deque append, never a
        window copy; deque end-indexing fetches the pair leaving the
        trailing fast window without touching the rest."""
        evicted = None
        if len(self.window) == self.window.maxlen:
            evicted = self.window[0]  # about to be evicted by append
            self.slow_good -= evicted[0]
            self.slow_bad -= evicted[1]
        self.window.append((self.cur_good, self.cur_bad))
        self.slow_good += self.cur_good
        self.slow_bad += self.cur_bad
        self.fast_good += self.cur_good
        self.fast_bad += self.cur_bad
        if len(self.window) > fast_window:
            # the (fast_window+1)-th pair from the right just left the
            # trailing fast window and is still in the deque
            g, b = self.window[-fast_window - 1]
            self.fast_good -= g
            self.fast_bad -= b
        elif evicted is not None and len(self.window) == fast_window:
            # slow_window == fast_window: the leaving pair IS the one
            # the maxlen append evicted
            self.fast_good -= evicted[0]
            self.fast_bad -= evicted[1]
        self.cur_good = 0
        self.cur_bad = 0
        fg, fb = self.fast_good, self.fast_bad
        budget = self.objective.error_budget
        self.fast_burn = (fb / (fg + fb) / budget) if (fg + fb) else 0.0
        self.slow_burn = (self.slow_bad
                          / (self.slow_good + self.slow_bad)
                          / budget) \
            if (self.slow_good + self.slow_bad) else 0.0
        active = (self.fast_burn >= burn_threshold
                  and self.slow_burn >= burn_threshold)
        if active == self.alert_active:
            return None
        self.alert_active = active
        if active:
            self.alerts_fired += 1
        return active


class SLOTracker:
    """Evaluate a set of :class:`Objective` promises over rolling tick
    windows; the engine owns one (``ServingEngine(slo=tracker)``) and
    feeds it from the real metrics path.

    Windows are counted in TICKS (the engine's scheduling quantum), so
    deterministic pump-mode tests drive alerting with zero wall-clock
    dependence — exactly how the deadline machinery is tested.
    """

    def __init__(self, objectives: Sequence[Objective],
                 fast_window: int = 5, slow_window: int = 60,
                 burn_threshold: float = 1.0):
        objectives = list(objectives)
        if not objectives:
            raise InvalidArgumentError(
                "SLOTracker needs at least one Objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise InvalidArgumentError(
                "objective names must be unique, got %r" % (names,))
        if int(fast_window) < 1 or int(slow_window) < int(fast_window):
            raise InvalidArgumentError(
                "need 1 <= fast_window <= slow_window, got fast=%r "
                "slow=%r" % (fast_window, slow_window))
        if not float(burn_threshold) > 0.0:
            raise InvalidArgumentError(
                "burn_threshold must be > 0, got %r" % (burn_threshold,))
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.burn_threshold = float(burn_threshold)
        self._states: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState(o, self.slow_window)
            for o in objectives}
        self.ticks = 0
        self._gauges: Optional[dict] = None

    # -- fed from the engine's real path ---------------------------------
    def observe_latency(self, kind: str, seconds: float) -> None:
        """One TTFT or inter-token observation (engine ``_on_token``)."""
        for st in self._states.values():
            o = st.objective
            if o.kind == kind:
                st.observe(seconds > o.threshold_s)

    def observe_terminal(self, state: str) -> None:
        """One request reached a terminal state (engine ``_finalize``)."""
        for st in self._states.values():
            o = st.objective
            if o.kind == "availability":
                st.observe(state in o.bad_states)

    def note_tick(self) -> None:
        """Roll every objective's windows at the tick boundary; alert
        flips land in the flight recorder and the structured log the
        moment they happen."""
        self.ticks += 1
        for st in self._states.values():
            flipped = st.roll(self.fast_window, self.burn_threshold)
            if flipped is None:
                continue
            event = "slo.alert" if flipped else "slo.alert_cleared"
            trace.instant(event, objective=st.objective.name,
                          fast_burn=round(st.fast_burn, 4),
                          slow_burn=round(st.slow_burn, 4))
            slog.emit(event, objective=st.objective.name,
                      fast_burn=round(st.fast_burn, 4),
                      slow_burn=round(st.slow_burn, 4),
                      burn_threshold=self.burn_threshold)
        if self._gauges is not None:
            for name, st in self._states.items():
                g = self._gauges[name]
                g["fast"].set(st.fast_burn)
                g["slow"].set(st.slow_burn)
                g["active"].set(1.0 if st.alert_active else 0.0)
                g["budget"].set(max(0.0, 1.0 - st.slow_burn))

    # -- export surfaces --------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Register per-objective gauges on ``registry`` so the SLO
        state rides every ``render_prometheus()`` scrape.  Idempotent
        per registry (create-or-get semantics)."""
        gauges = {}
        for name, st in self._states.items():
            o = st.objective
            gauges[name] = {
                "fast": registry.gauge(
                    "serving_slo_%s_burn_rate_fast" % name,
                    "error-budget burn rate over the fast %d-tick "
                    "window (%s)" % (self.fast_window, o.kind)),
                "slow": registry.gauge(
                    "serving_slo_%s_burn_rate_slow" % name,
                    "error-budget burn rate over the slow %d-tick "
                    "window" % self.slow_window),
                "active": registry.gauge(
                    "serving_slo_%s_alert_active" % name,
                    "1 while both windows burn >= the threshold"),
                "budget": registry.gauge(
                    "serving_slo_%s_budget_remaining" % name,
                    "1 - slow-window burn rate, floored at 0"),
            }
        self._gauges = gauges

    @property
    def alerts_active(self) -> int:
        return sum(1 for st in self._states.values() if st.alert_active)

    def alerting_names(self) -> List[str]:
        """Names of objectives whose multi-window alert is ACTIVE right
        now (both burn windows at/over the threshold) — the control
        signal the serving engine's degradation ladder steps on.  Plain
        attribute reads, safe from the tick path (one tuple walk per
        tick when a ladder is configured)."""
        return [name for name, st in self._states.items()
                if st.alert_active]

    def health_summary(self) -> dict:
        """The compact record ``ServingEngine.health()`` folds in —
        plain-attribute reads only, safe lock-free during a wedge."""
        return {
            "alerts_active": self.alerts_active,
            "alerting": sorted(name for name, st in self._states.items()
                               if st.alert_active),
            "ticks": self.ticks,
        }

    def snapshot(self) -> dict:
        """The full JSON-safe state — the ``GET /slo`` body."""
        objectives = []
        for name, st in self._states.items():
            o = st.objective
            objectives.append({
                "name": name,
                "kind": o.kind,
                "target": o.target,
                "threshold_s": o.threshold_s,
                "error_budget": o.error_budget,
                "bad_states": (sorted(o.bad_states)
                               if o.kind == "availability" else None),
                "description": o.description,
                "fast_burn_rate": st.fast_burn,
                "slow_burn_rate": st.slow_burn,
                "alert_active": st.alert_active,
                "alerts_fired": st.alerts_fired,
                "window_good": st.slow_good,
                "window_bad": st.slow_bad,
                "total_good": st.total_good,
                "total_bad": st.total_bad,
            })
        return {
            "fast_window_ticks": self.fast_window,
            "slow_window_ticks": self.slow_window,
            "burn_threshold": self.burn_threshold,
            "ticks": self.ticks,
            "alerts_active": self.alerts_active,
            "objectives": objectives,
        }
