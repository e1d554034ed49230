"""Functional ops of the port (counterpart of ``paddle_tpu.nn.functional``).

The namespace's functions are installed behind the autocast shim
(``framework.dispatch.install_ops``), so each is the op of its name for
the ``amp`` lists: ``linear`` is white, ``cross_entropy`` and
``softmax_with_cross_entropy`` are black, the others pass their inputs
through.  Calls inside the submodules reach the raw functions."""
from .activation import gelu, relu  # noqa: F401
from .common import (dropout, embedding, linear,  # noqa: F401
                     scaled_dot_product_attention)
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
from ...framework import dispatch as _dispatch

_dispatch.install_ops(globals())
