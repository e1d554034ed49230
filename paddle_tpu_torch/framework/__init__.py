"""``paddle_tpu_torch.framework``: the grad engine's surface.

The reference's ``framework/tensor.py`` (the Tensor facade) has no
counterpart, and ``framework/dispatch.py`` (unwrap, run, wrap and tape
each op) only its op shim, autocast and the nan/inf check
(``dispatch.install_ops``): ``torch.Tensor`` is the port's Tensor,
``nn.Parameter`` its Parameter, and torch's autograd records the graph.
Row-sparse gradients are ``framework/sparse.py``'s.
"""
from .engine import (backward, enable_grad, grad,  # noqa: F401
                     is_grad_enabled, no_grad, set_grad_enabled)
