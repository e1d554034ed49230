"""Decode sessions, cache layouts and training steps (counterpart of
``paddle_tpu.jit``)."""
from .cache import get_layout  # noqa: F401
from .decode import DecodeSession, truncate_at_eos  # noqa: F401
from .speculative import SpeculativeDecodeSession  # noqa: F401
from .train_step import MultiStepTrainStep, TrainStep  # noqa: F401
