"""``paddle_tpu_torch.vision`` (counterpart of ``paddle_tpu.vision``):
the model zoo (``models``), the detection ops (``ops``) and the image
preprocessing (``transforms``).  ``datasets`` and the image-backend
functions are not ported yet."""
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401

__all__ = ["models", "ops", "transforms"]
