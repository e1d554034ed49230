"""Functional ops of the port (counterpart of ``paddle_tpu.nn.functional``).

The namespace's functions are installed behind the autocast shim
(``framework.dispatch.install_ops``), so each is the op of its name for
the ``amp`` lists: ``linear`` is white; ``cross_entropy``,
``softmax_with_cross_entropy`` and the losses the black list names
(``nll_loss``, ``mse_loss``, ``kl_div``, ...) are black; the others pass
their inputs through.  Calls inside the submodules reach the raw
functions."""
from .activation import gelu, relu  # noqa: F401
from .common import (dropout, embedding, linear,  # noqa: F401
                     scaled_dot_product_attention)
from .loss import (bce_loss, binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_similarity,
                   cross_entropy, ctc_loss, dice_loss, hinge_embedding_loss,
                   hsigmoid_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss, npair_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost)
from .norm import layer_norm  # noqa: F401
from ...framework import dispatch as _dispatch

_dispatch.install_ops(globals())
