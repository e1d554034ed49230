"""``paddle_tpu_torch.tensor``: tensor creation (``to_tensor``) and
``matmul``.  The namespace's functions are installed behind the autocast
shim (``framework.dispatch.install_ops``), as the reference installs its
tensor ops: ``matmul`` is the white-listed op of that name."""
from .creation import to_tensor  # noqa: F401
from .linalg import matmul  # noqa: F401
from ..framework import dispatch as _dispatch

_dispatch.install_ops(globals())
