"""Functional ops of the port (counterpart of ``paddle_tpu.nn.functional``)."""
from .activation import gelu, relu  # noqa: F401
from .common import (dropout, embedding, linear,  # noqa: F401
                     scaled_dot_product_attention)
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
