"""``paddle_tpu_torch.utils``: the C++ extension path (``cpp_extension``).
The rest of the reference's ``utils`` is still to port."""
from . import cpp_extension  # noqa: F401

__all__ = ["cpp_extension"]
