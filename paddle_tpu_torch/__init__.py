"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper.

Module paths mirror the reference package's, so each counterpart is found
at the same place.  The port imports torch and never JAX or the reference
package.  Its entry points (``TransformerLM``, ``DecodeSession``,
``GenerationPool``, ``ServingEngine``) run on ``cuda`` by default and raise
on a machine without a card unless the caller passes ``device="cpu"``.
"""
from .convert import load_reference_params  # noqa: F401
from .core.errors import (EnforceNotMet, InvalidArgumentError,  # noqa: F401
                          NotFoundError, PreconditionNotMetError,
                          UnavailableError)
from .inference.generation import GenerationPool  # noqa: F401
from .jit.decode import DecodeSession  # noqa: F401
from .models.language_model import TransformerLM, gpt_1p3b_config  # noqa: F401
from .serving.engine import QueueFullError, ServingEngine  # noqa: F401
