"""The serving engine (counterpart of ``paddle_tpu.serving``)."""
from .engine import QueueFullError, ServingEngine  # noqa: F401
from .stream import RequestState, ResponseStream, StreamStatus  # noqa: F401
