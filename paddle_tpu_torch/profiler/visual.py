"""Chrome trace export (counterpart of the reference's
``profiler/visual.py``, its shared writer only).

:func:`chrome_trace_json` is the one writer behind the serving flight
recorder's export (``serving.trace.export_chrome_trace``): a prepared
trace-event list becomes the standard ``{"traceEvents": [...]}``
document that ``chrome://tracing`` and Perfetto load.  The reference's
``LogWriter`` and op-table export wait for the rest of the profiler.
"""
from __future__ import annotations

import json
from typing import List, Optional

__all__ = ["chrome_trace_json"]


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
