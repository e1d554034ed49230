"""``paddle_tpu_torch.tensor``: tensor creation (``to_tensor``)."""
from .creation import to_tensor  # noqa: F401
