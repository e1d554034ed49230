"""``paddle_tpu_torch.vision`` (counterpart of ``paddle_tpu.vision``): the
model zoo's LeNet and ResNet family.  Datasets, transforms, ``ops`` and
the other models are not ported yet."""
from . import models  # noqa: F401

__all__ = ["models"]
