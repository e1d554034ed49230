"""Scalar logging and the chrome trace writer (counterpart of the
reference's ``profiler/visual.py``, without its op-table export).

:class:`LogWriter` is VisualDL's scalar surface over a JSONL file (one
point a line: tag, value, step, wall time), as the reference stores it;
``hapi.callbacks.VisualDL`` writes through it.  :func:`chrome_trace_json`
is the one writer behind the serving flight recorder's export
(``serving.trace.export_chrome_trace``): a prepared trace-event list
becomes the standard ``{"traceEvents": [...]}`` document that
``chrome://tracing`` and Perfetto load.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

__all__ = ["LogWriter", "chrome_trace_json"]


class LogWriter:
    """VisualDL's ``LogWriter`` (scalars) over ``<logdir>/<file_name>``."""

    def __init__(self, logdir: str, file_name: str = "scalars.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._path = os.path.join(logdir, file_name)
        self._f = open(self._path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "wall": time.time()}) + "\n")

    def add_scalars(self, main_tag: str, tag_value: Dict, step: int) -> None:
        for k, v in tag_value.items():
            self.add_scalar("%s/%s" % (main_tag, k), v, step)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def read(logdir: str, tag: Optional[str] = None,
             file_name: str = "scalars.jsonl") -> List[dict]:
        """The points written so far (of ``tag`` only, when given)."""
        out = []
        with open(os.path.join(logdir, file_name)) as f:
            for line in f:
                rec = json.loads(line)
                if tag is None or rec["tag"] == tag:
                    out.append(rec)
        return out


def chrome_trace_json(trace_events: List[dict],
                      path: Optional[str] = None) -> str:
    """Serialize ``trace_events`` to the ``{"traceEvents": [...]}``
    JSON document; returns the string and writes it to ``path`` (with a
    ``.json`` suffix added when missing) when given."""
    s = json.dumps({"traceEvents": trace_events, "displayTimeUnit": "ms"})
    if path is not None:
        if not path.endswith(".json"):
            path += ".json"
        with open(path, "w") as f:
            f.write(s)
    return s


def export_chrome_tracing(path: str, op_times: Optional[List] = None) -> str:
    """Write the op profiler's table as Chrome trace events.

    ``op_times``: a list of (name, seconds[, start_seconds]).  By default
    the profiler's per-op totals (``start_profiler`` must have run), laid
    out one after another: a cost breakdown, not a timeline (the table
    keeps totals, not timestamps).  Loadable in chrome://tracing or
    Perfetto."""
    if op_times is None:
        from . import _events

        op_times = [(name, total) for name, (_cnt, total) in _events.items()]
    events = []
    cursor = 0.0
    for rec in op_times:
        name, dur = rec[0], float(rec[1])
        start = float(rec[2]) if len(rec) > 2 else cursor
        cursor = start + dur
        events.append({
            "name": name, "ph": "X", "pid": 0, "tid": 0,
            "ts": start * 1e6, "dur": dur * 1e6,
            "cat": "op",
        })
    if not path.endswith(".json"):
        path += ".json"
    chrome_trace_json(events, path)
    return path
