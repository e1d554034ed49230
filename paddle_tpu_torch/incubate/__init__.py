"""``paddle_tpu_torch.incubate``: functional autodiff, custom ops and the
masked-softmax operators (counterpart of the reference's
``incubate/__init__.py``, without ``auto_checkpoint``, ``asp`` and the
``LookAhead``/``ModelAverage`` re-exports, which are still to port).
"""
from . import autograd  # noqa: F401
from . import operators  # noqa: F401
from .custom_op import (get_custom_op, register_custom_op,  # noqa: F401
                        registered_custom_ops)
from .operators import (softmax_mask_fuse,  # noqa: F401
                        softmax_mask_fuse_upper_triangle)

__all__ = ["autograd", "operators", "get_custom_op", "register_custom_op",
           "registered_custom_ops", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]
