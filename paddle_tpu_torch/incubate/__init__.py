"""``paddle_tpu_torch.incubate``: functional autodiff, custom ops, the
masked-softmax operators, ASP sparsity (``asp``) and auto-checkpoint
(``auto_checkpoint``) (counterpart of the reference's
``incubate/__init__.py``, without the ``LookAhead``/``ModelAverage``
re-exports).
"""
from . import asp  # noqa: F401
from . import auto_checkpoint  # noqa: F401
from . import autograd  # noqa: F401
from . import operators  # noqa: F401
from .auto_checkpoint import AutoCheckpoint, train_epoch_range  # noqa: F401
from .custom_op import (get_custom_op, register_custom_op,  # noqa: F401
                        registered_custom_ops)
from .operators import (softmax_mask_fuse,  # noqa: F401
                        softmax_mask_fuse_upper_triangle)

__all__ = ["asp", "auto_checkpoint", "AutoCheckpoint", "train_epoch_range",
           "autograd", "operators", "get_custom_op", "register_custom_op",
           "registered_custom_ops", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]
