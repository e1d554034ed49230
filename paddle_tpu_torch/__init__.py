"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper.

Module paths mirror the reference package's, so each counterpart is found
at the same place.  The port imports torch and never JAX or the reference
package.  Its entry points (``TransformerLM``, ``DecodeSession``,
``GenerationPool``, ``ServingEngine``) run on ``cuda`` by default and raise
on a machine without a card unless the caller passes ``device="cpu"``.
Training goes through ``TrainStep`` (or the optimizer's eager ``step()``)
on whatever device the model lives: pretraining a ``TransformerLM``, or
fine-tuning a ``TransformerForSequenceClassification`` (the ERNIE
fine-tune, ``ernie_base_config()``).  ``nn.Embedding(sparse=True)`` gives
row-sparse gradients that ``optimizer.SGD`` and ``Adam(lazy_mode=True)``
update row by row; ``nn.functional`` has the reference's twenty losses.
``vision.models`` has ``LeNet`` and the ResNet family (conv, pooling,
BatchNorm and the 28 activations in ``nn``), trained through the same
``TrainStep``; ``ParamAttr``/``create_parameter`` and ``nn.initializer``
configure parameters, and ``distributed.fleet.utils.recompute``
checkpoints activations.
The ``tensor`` ops are exported here too (creation ops take
``place=``).  ``seed()`` seeds the CPU and CUDA generators
(``get_rng_state``/``set_rng_state`` carry their states);
``set_flags``/``get_flags`` hold the reference's ten ``FLAGS_*``, e.g.
``FLAGS_check_nan_inf``, which makes every installed op raise on a nan or
inf output.  ``torch.Tensor`` is the port's
Tensor (paddle's ``stop_gradient`` is ``not requires_grad``); ``grad``,
``autograd.PyLayer``, ``incubate.register_custom_op`` and
``incubate.autograd`` differentiate through torch's autograd.  ``amp``
trains in bf16 (or fp16) mixed precision: ``amp.decorate(level="O2")``
and ``amp.auto_cast`` around the loss, as the reference's training legs.
A server is ``ServingEngine(model, ...).start()`` behind
``ServingHTTPFrontend(engine).start()``; ``mesh=DecodeMesh(dp, mp,
devices=["cuda:0"] * (dp * mp))`` shards its pool (``jit.mesh``).
"""
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import distributed  # noqa: F401
from . import incubate  # noqa: F401
from . import optimizer  # noqa: F401
from . import serving  # noqa: F401
from . import vision  # noqa: F401
from .convert import load_reference_params  # noqa: F401
from .core.errors import (EnforceNotMet, InvalidArgumentError,  # noqa: F401
                          NotFoundError, PreconditionNotMetError,
                          UnavailableError)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import (get_cuda_rng_state, get_rng_state,  # noqa: F401
                          seed, set_cuda_rng_state, set_rng_state)
from .framework.engine import (enable_grad, grad,  # noqa: F401
                               is_grad_enabled, no_grad, set_grad_enabled)
from . import tensor  # noqa: F401
from .tensor import *  # noqa: F401,F403
from .inference.generation import GenerationPool  # noqa: F401
from .jit.decode import DecodeSession  # noqa: F401
from .jit.mesh import DecodeMesh  # noqa: F401
from .jit.train_step import MultiStepTrainStep, TrainStep  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
from .models.language_model import (  # noqa: F401
    TransformerForSequenceClassification, TransformerLM,
    TransformerLMCriterion, bert_base_config, ernie_base_config,
    gpt_1p3b_config)
from .serving import (AdmissionTightenedError,  # noqa: F401
                      DeadlineUnattainableError, QueueFullError,
                      ServingEngine, ServingHTTPFrontend)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, place=None):
    """paddle.create_parameter: a parameter made as a layer makes one
    (``nn.layer.layers.create_parameter``), on ``place`` (None: ``cuda``)
    and named ``name`` for the optimizers."""
    from .core.device import resolve_device
    from .nn.layer.layers import create_parameter as _create

    p = _create(shape, attr=attr, dtype=dtype, is_bias=is_bias,
                default_initializer=default_initializer,
                device=resolve_device(place))
    if name:
        p.param_name = name
    return p
