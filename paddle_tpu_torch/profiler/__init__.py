"""Step timing and scalar logging (counterpart of the reference's
``profiler``: its ``StepTimer`` and ``LogWriter``).

The serving engine times each tick with :class:`StepTimer`; its mean
step time is what the deadline-shed estimate and the
``serving_tokens_per_sec`` / ``serving_step_time_s`` gauges read.  The
reference's MFU fields (which need a device peak), device trace and op
profiler wait for the rest of the profiler.
"""
from __future__ import annotations

import time

from .visual import LogWriter  # noqa: F401

__all__ = ["StepTimer", "LogWriter"]


class StepTimer:
    """Wall time of the steps timed so far: use it as a context manager
    around each step."""

    def __init__(self):
        self._t0 = None
        self.steps = 0
        self.total = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.steps += 1

    @property
    def step_time(self) -> float:
        return self.total / max(self.steps, 1)
