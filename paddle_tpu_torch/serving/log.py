"""Structured serving logs as stdlib-``logging`` JSON lines (counterpart
of the reference's ``serving/log.py``).

One JSON object per line for each interesting edge -- ``req.admitted``,
``req.terminal``, ``req.shed``, ``engine.recovery``, ``engine.restart``,
``engine.stall``, ``slo.alert`` / ``slo.alert_cleared`` and the
degradation ladder's ``sched.preempt`` / ``sched.resume`` /
``sched.degrade`` / ``sched.restore`` -- carrying ``ts`` (wall clock),
``event``, ``rid`` when the event belongs to a request, the event's own
fields, and ``tick``, the current trace tick whenever a tracer is
installed, so a log line joins the flight recorder's timeline by number.

Unconfigured, module :func:`emit` is one global ``is None`` test: no
allocation, no formatting on the tick path.
"""
from __future__ import annotations

import contextlib
import json
import logging
import sys
import time
from typing import Optional

from . import trace

__all__ = ["JsonLinesLogger", "emit", "install", "uninstall", "active",
           "logging_to"]


class JsonLinesLogger:
    """One-line-JSON event emitter over a stdlib logger.

    ``stream`` (default ``sys.stderr``) gets an isolated, propagation-
    free ``logging.Logger`` so configuring serving logs can never
    double-print through the root logger; pass ``logger=`` instead to
    route events into an existing logging setup (the formatter should
    print the bare message — the message IS the JSON line).
    ``clock`` defaults to ``time.time`` — log timestamps are WALL
    clock (the ops-pipeline convention), unlike trace/engine
    monotonics; the ``tick`` field is the cross-domain join key."""

    def __init__(self, stream=None, logger: Optional[logging.Logger] = None,
                 clock=None):
        self._clock = clock if clock is not None else time.time
        if logger is None:
            logger = logging.Logger("paddle_tpu_torch.serving.jsonl")
            handler = logging.StreamHandler(
                stream if stream is not None else sys.stderr)
            handler.setFormatter(logging.Formatter("%(message)s"))
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            logger.propagate = False
        self._logger = logger
        self.events_emitted = 0

    def emit(self, event: str, rid=None, **fields) -> None:
        """Emit one event line.  None-valued fields are dropped (a
        terminal with no error carries no ``error`` key); non-JSON
        values degrade to ``str`` rather than killing the serving
        path."""
        rec = {"ts": round(self._clock(), 6), "event": event}
        if rid is not None:
            rec["rid"] = rid
        tr = trace.active()
        if tr is not None:
            rec["tick"] = tr.tick
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        self.events_emitted += 1
        self._logger.info("%s", json.dumps(rec, default=str))


# -- module-level activation (the fault-plane pattern) --------------------
# ONE global logger: unconfigured, every call site pays a single
# is-None test — nothing else touches the tick path.
_LOGGER: Optional[JsonLinesLogger] = None


def emit(event: str, rid=None, **fields) -> None:
    """The emission seam call sites use: a no-op unless a logger is
    installed."""
    logger = _LOGGER
    if logger is not None:
        logger.emit(event, rid=rid, **fields)


def install(logger: JsonLinesLogger) -> JsonLinesLogger:
    """Activate ``logger`` process-wide; returns it.  Refuses to stack
    (two writers would interleave half the events each)."""
    global _LOGGER
    if _LOGGER is not None:
        from ..core.errors import PreconditionNotMetError
        raise PreconditionNotMetError(
            "a serving logger is already installed; uninstall() it "
            "first (one structured-log stream per process)")
    _LOGGER = logger
    return logger


def uninstall() -> None:
    """Deactivate structured logging (idempotent)."""
    global _LOGGER
    _LOGGER = None


def active() -> Optional[JsonLinesLogger]:
    """The installed logger, or None when logging is off."""
    return _LOGGER


@contextlib.contextmanager
def logging_to(target):
    """``with log.logging_to(stream):`` — install a
    :class:`JsonLinesLogger` over ``target`` (a writable text stream,
    or an existing ``JsonLinesLogger``) for the block, always uninstall
    after, so a failing test cannot leak a logger into the next one."""
    logger = target if isinstance(target, JsonLinesLogger) \
        else JsonLinesLogger(stream=target)
    install(logger)
    try:
        yield logger
    finally:
        uninstall()
