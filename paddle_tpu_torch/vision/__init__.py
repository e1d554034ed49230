"""``paddle_tpu_torch.vision`` (counterpart of ``paddle_tpu.vision``):
the model zoo (``models``), the detection ops (``ops``), the image
preprocessing (``transforms``), the datasets read from files on disk
(``datasets``) and the image backend (``set_image_backend``,
``get_image_backend``, ``image_load``)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401

__all__ = ["datasets", "models", "ops", "transforms", "set_image_backend",
           "get_image_backend", "image_load"]


_image_backend = "cv2"


def set_image_backend(backend: str) -> None:
    """Select the decode backend: ``"cv2"`` (numpy HWC arrays) or
    ``"pil"`` (PIL images)."""
    from ..core.errors import InvalidArgumentError

    if backend not in ("pil", "cv2"):
        raise InvalidArgumentError(
            "image backend must be 'pil' or 'cv2', got %r" % backend)
    global _image_backend
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path: str, backend=None):
    """Load an image file: a numpy HWC array for ``"cv2"``, a PIL image for
    ``"pil"`` (PIL decodes both; it is imported here, when called)."""
    from .transforms import _pil_image

    img = _pil_image().open(path)
    if (backend or _image_backend) == "pil":
        return img
    import numpy as np

    return np.asarray(img)
