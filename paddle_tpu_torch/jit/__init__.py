"""Decode sessions, cache layouts, training steps and ``InputSpec``
(counterpart of ``paddle_tpu.jit``)."""
from .cache import CACHE_LAYOUTS, RecurrentLayout, get_layout  # noqa: F401
from .decode import DecodeSession, truncate_at_eos  # noqa: F401
from .mesh import DecodeMesh  # noqa: F401
from .speculative import SpeculativeDecodeSession  # noqa: F401
from .train_step import MultiStepTrainStep, TrainStep  # noqa: F401


class InputSpec:
    """An input's signature: ``shape`` (``None`` for a dimension left
    open, such as the batch), ``dtype`` and ``name``; what ``Model(inputs=)``
    and ``summary`` take.  The reference's static ``jit`` around it
    (``to_static``, ``save``) is not ported."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        from ..core.dtype import convert_dtype

        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype, name=name)

    def __repr__(self):
        return "InputSpec(shape=%s, dtype=%s, name=%s)" % (
            self.shape, self.dtype, self.name)
