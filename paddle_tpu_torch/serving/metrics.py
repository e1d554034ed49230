"""Serving metrics: counters, gauges, histograms and the Prometheus text
exposition (counterpart of the reference's ``serving/metrics.py``).

A small registry -- no labels, no background collection -- because the
engine records from the real code path: admission increments counters
inside ``submit()``, TTFT is observed by the pool's ``on_token`` hook at
the first token, the recovery, shedding, preemption and watchdog
counters increment inside those paths, and the KV gauges read
``cache_stats()`` after every tick.  ``snapshot()`` returns plain Python;
``render_prometheus()`` follows the text format (counters end in
``_total``, histograms emit cumulative ``_bucket{le=...}`` plus
``_sum``/``_count``).
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, Optional, Sequence

from ..core.errors import InvalidArgumentError

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS", "escape_help", "escape_label_value"]

# latency buckets spanning sub-millisecond CPU test steps to the
# multi-second TTFTs of a cold bucket compile on a loaded server
DEFAULT_TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _fmt(v: float) -> str:
    return "%.10g" % float(v)


def escape_help(s: str) -> str:
    """Prometheus text-format HELP escaping: ``\\`` and newline (a raw
    newline would split one HELP across two exposition lines, breaking
    the scrape; the format spec says escape exactly these two)."""
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(s: str) -> str:
    """Prometheus label-value escaping: ``\\``, newline, and ``"`` (the
    value is double-quoted in the exposition, so an unescaped quote
    truncates it mid-value)."""
    return str(s).replace("\\", "\\\\").replace("\n", "\\n") \
        .replace('"', '\\"')


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise InvalidArgumentError(
                "metric name %r is not a valid prometheus identifier "
                "([a-zA-Z_:][a-zA-Z0-9_:]*)" % (name,))
        self.name = name
        self.help = help


class Counter(_Metric):
    """Monotonic count (requests, tokens, rejections)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise InvalidArgumentError(
                "counter %s only goes up (inc %r); use a Gauge for "
                "values that fall" % (self.name, n))
        self.value += n

    def snapshot(self):
        return self.value


class Gauge(_Metric):
    """Point-in-time value (queue depth, slot occupancy, tokens/s)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram(_Metric):
    """Fixed-bucket distribution (TTFT, inter-token latency).

    Buckets are upper bounds (prometheus ``le`` semantics); an
    observation lands in the first bucket whose bound >= value, or the
    implicit ``+Inf`` overflow.  ``quantile(q)`` returns the upper
    bound of the bucket containing the q-quantile — an upper ESTIMATE,
    the histogram_quantile convention, exact only in distribution."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise InvalidArgumentError(
                "histogram %s buckets must be non-empty and strictly "
                "increasing, got %r" % (name, buckets))
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._counts[bisect.bisect_left(self.buckets, v)] += 1

    def reset(self) -> None:
        """Zero all counts, keeping the bucket layout.  For callers that
        warm a code path (compile, cache fill) before the measurement
        window and must not let the warmup observations pollute
        engine-lifetime quantiles."""
        self._counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def quantile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise InvalidArgumentError(
                "quantile must be in [0, 1], got %r" % (q,))
        if not self.count:
            return None
        target = q * self.count
        running = 0
        for i, c in enumerate(self._counts):
            running += c
            if running and running >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")

    def snapshot(self):
        cum: Dict[str, int] = {}
        running = 0
        for b, c in zip(self.buckets, self._counts):
            running += c
            cum[_fmt(b)] = running
        cum["+Inf"] = self.count
        return {"count": self.count, "sum": self.sum, "buckets": cum}


class MetricsRegistry:
    """Create-or-get registry of named metrics.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the name is already registered (so engine restarts over a shared
    registry accumulate instead of clobbering) and refuse a name
    registered under a different type."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls:
                raise InvalidArgumentError(
                    "metric %r is already registered as a %s, not a %s"
                    % (name, m.kind, cls.kind))
            want = kwargs.get("buckets")
            if want is not None and \
                    tuple(float(b) for b in want) != m.buckets:
                # returning the old histogram would silently mis-bucket
                # the new caller's observations
                raise InvalidArgumentError(
                    "histogram %r is already registered with buckets %s "
                    "(requested %s)" % (name, m.buckets, tuple(want)))
            return m
        m = cls(name, help, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset_all(self) -> None:
        """Zero every registered metric IN PLACE — counters and gauges
        to 0, histogram counts cleared — keeping the registrations,
        bucket layouts, and metric object identities (the engine holds
        direct references).  Test isolation for suites sharing one
        registry/engine, and the warm-outside-the-timed-region
        discipline bench legs apply per-histogram, available for a whole
        registry at once."""
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m.reset()
            else:
                m.value = 0.0

    def snapshot(self) -> dict:
        """{name: value | {count, sum, buckets}} — plain python, JSON
        and test friendly."""
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def render_prometheus(self) -> str:
        """Text exposition format (one scrape body).  HELP strings and
        label values are escaped per the format spec (``\\``/newline,
        plus ``"`` in label values) — a metric whose help text quotes an
        error message must not be able to corrupt the whole scrape."""
        lines = []
        for m in self._metrics.values():
            if m.help:
                lines.append("# HELP %s %s"
                             % (m.name, escape_help(m.help)))
            lines.append("# TYPE %s %s" % (m.name, m.kind))
            if isinstance(m, Histogram):
                running = 0
                for b, c in zip(m.buckets, m._counts):
                    running += c
                    lines.append('%s_bucket{le="%s"} %d'
                                 % (m.name,
                                    escape_label_value(_fmt(b)),
                                    running))
                lines.append('%s_bucket{le="+Inf"} %d'
                             % (m.name, m.count))
                lines.append("%s_sum %s" % (m.name, _fmt(m.sum)))
                lines.append("%s_count %d" % (m.name, m.count))
            else:
                lines.append("%s %s" % (m.name, _fmt(m.value)))
        return "\n".join(lines) + "\n"
