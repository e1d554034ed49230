"""Layers and functionals of the port (counterpart of ``paddle_tpu.nn``)."""
from . import functional  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.norm import LayerNorm  # noqa: F401
from .layer.transformer import (MultiHeadAttention,  # noqa: F401
                                TransformerEncoder, TransformerEncoderLayer)
