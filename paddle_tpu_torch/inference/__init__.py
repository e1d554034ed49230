"""Continuous batching (counterpart of ``paddle_tpu.inference``)."""
from .generation import (DuplicateRequestError, GenerationPool,  # noqa: F401
                         kv_reachable_bytes)
from .speculative import SpeculativePool  # noqa: F401
