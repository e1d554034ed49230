"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper.

Module paths mirror the reference package's, so each counterpart is found
at the same place.  The port imports torch and never JAX or the reference
package.  Its entry points (``TransformerLM``, ``DecodeSession``,
``GenerationPool``, ``ServingEngine``) run on ``cuda`` by default and raise
on a machine without a card unless the caller passes ``device="cpu"``.
Training goes through ``TrainStep`` (or the optimizer's eager ``step()``)
on whatever device the model lives.  ``torch.Tensor`` is the port's
Tensor (paddle's ``stop_gradient`` is ``not requires_grad``); ``grad``,
``autograd.PyLayer``, ``incubate.register_custom_op`` and
``incubate.autograd`` differentiate through torch's autograd.  ``amp``
trains in bf16 (or fp16) mixed precision: ``amp.decorate(level="O2")``
and ``amp.auto_cast`` around the loss, as the reference's training legs.
A server is ``ServingEngine(model, ...).start()`` behind
``ServingHTTPFrontend(engine).start()``.
"""
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import incubate  # noqa: F401
from . import optimizer  # noqa: F401
from . import serving  # noqa: F401
from .convert import load_reference_params  # noqa: F401
from .core.errors import (EnforceNotMet, InvalidArgumentError,  # noqa: F401
                          NotFoundError, PreconditionNotMetError,
                          UnavailableError)
from .framework.engine import (enable_grad, grad,  # noqa: F401
                               is_grad_enabled, no_grad, set_grad_enabled)
from .tensor import matmul  # noqa: F401
from .tensor.creation import to_tensor  # noqa: F401
from .inference.generation import GenerationPool  # noqa: F401
from .jit.decode import DecodeSession  # noqa: F401
from .jit.train_step import MultiStepTrainStep, TrainStep  # noqa: F401
from .models.language_model import (TransformerLM,  # noqa: F401
                                    TransformerLMCriterion, bert_base_config,
                                    ernie_base_config, gpt_1p3b_config)
from .serving import (AdmissionTightenedError,  # noqa: F401
                      DeadlineUnattainableError, QueueFullError,
                      ServingEngine, ServingHTTPFrontend)
