"""The serving engine (counterpart of ``paddle_tpu.serving``)."""
from .engine import (PRIORITY_CLASSES, QueueFullError,  # noqa: F401
                     ServingEngine)
from .stream import RequestState, ResponseStream, StreamStatus  # noqa: F401
