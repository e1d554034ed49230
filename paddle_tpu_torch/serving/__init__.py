"""The serving layer (counterpart of ``paddle_tpu.serving``): the engine
with its background loop, deadlines, recovery and degradation ladder,
token streams, metrics, SLOs, structured logs, tracing, the fault plane,
the supervisor, the HTTP front end, the request journal with
checkpoint/restore, the PTKV transfer format, the disaggregated
prefill/decode front and the multi-engine fleet with its supervisor.
``DecodeMesh`` (from ``jit.mesh``) is the ``mesh=`` a sharded engine
takes."""
from . import faults, journal, log, slo, trace, transfer  # noqa: F401
from .disagg import DisaggregatedServing  # noqa: F401
from .engine import (PRIORITY_CLASSES, AdmissionTightenedError,  # noqa: F401
                     DeadlineUnattainableError, QueueFullError,
                     ServingEngine)
from .fleet import ServingFleet  # noqa: F401
from ..jit.mesh import DecodeMesh  # noqa: F401
from .http import ServingHTTPFrontend, parse_generate_request  # noqa: F401
from .log import JsonLinesLogger  # noqa: F401
from .metrics import (DEFAULT_TIME_BUCKETS, Counter, Gauge,  # noqa: F401
                      Histogram, MetricsRegistry)
from .slo import Objective, SLOTracker  # noqa: F401
from .stream import RequestState, ResponseStream, StreamStatus  # noqa: F401
from .supervisor import EngineHealth, FleetSupervisor, Supervisor  # noqa: F401
from .trace import FlightRecorder, TraceEvent, Tracer  # noqa: F401

__all__ = [
    "ServingEngine", "DisaggregatedServing", "ServingFleet", "DecodeMesh",
    "FleetSupervisor", "QueueFullError", "DeadlineUnattainableError",
    "AdmissionTightenedError", "PRIORITY_CLASSES",
    "ResponseStream", "StreamStatus", "RequestState",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_TIME_BUCKETS",
    "ServingHTTPFrontend", "parse_generate_request",
    "faults", "Supervisor", "EngineHealth",
    "trace", "Tracer", "FlightRecorder", "TraceEvent",
    "slo", "Objective", "SLOTracker",
    "log", "JsonLinesLogger", "journal", "transfer",
]
