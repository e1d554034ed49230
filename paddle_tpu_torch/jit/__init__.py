"""Decode sessions and cache layouts (counterpart of ``paddle_tpu.jit``)."""
from .cache import get_layout  # noqa: F401
from .decode import DecodeSession  # noqa: F401
