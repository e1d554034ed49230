"""Functional ops of the port (counterpart of ``paddle_tpu.nn.functional``).

The namespace's functions are installed behind the autocast shim
(``framework.dispatch.install_ops``), so each is the op of its name for
the ``amp`` lists: ``linear`` and the convolutions are white;
``softmax``, ``log_softmax``, ``cross_entropy``,
``softmax_with_cross_entropy`` and the losses the black list names
(``nll_loss``, ``mse_loss``, ``kl_div``, ...) are black; the others
(activations, pools, ``batch_norm``) pass their inputs through.  Calls
inside the submodules reach the raw functions.

``batch_norm`` is paddle's public form: it returns the output and
advances the running tensors in place.  ``_bn_triple`` is the
reference's pure ``(out, new_mean, new_var)`` form behind the shim.
``elu_``, ``softmax_`` and ``tanh_`` write the op's result into their
first argument, as the reference's in-place activations."""
from .activation import (elu, gelu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout, mish,
                         prelu, relu, relu6, relu_, selu, sigmoid, silu,
                         softmax, softplus, softshrink, softsign, swish, tanh,
                         tanhshrink, thresholded_relu)
from .common import (dropout, embedding, gather_tree,  # noqa: F401
                     label_smooth, linear, one_hot,
                     scaled_dot_product_attention, sequence_mask)
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import (bce_loss, binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_similarity,
                   cross_entropy, ctc_loss, dice_loss, hinge_embedding_loss,
                   hsigmoid_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss, npair_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost)
from .norm import batch_norm_ as batch_norm  # noqa: F401
from .norm import layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
from ...framework import dispatch as _dispatch
from . import norm as _norm


def _install():
    from ...tensor import _make_inplace

    _dispatch.install_ops(globals())
    globals()["_bn_triple"] = _dispatch.make_op(_norm.batch_norm,
                                                "batch_norm")
    for base in ("elu", "softmax", "tanh"):
        globals()[base + "_"] = _make_inplace(globals()[base], base + "_")


_install()
