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
``vision.models`` has the reference's zoo (LeNet, ResNet, VGG, the
MobileNets, AlexNet, SqueezeNet, ShuffleNetV2, DenseNet, GoogLeNet,
InceptionV3; conv, pooling, the norms and the 28 activations in ``nn``),
trained through the same ``TrainStep``; ``vision.ops`` the detection ops
and ``vision.transforms`` the host-side image transforms;
``ParamAttr``/``create_parameter`` and ``nn.initializer`` configure
parameters, and ``distributed.fleet.utils.recompute`` checkpoints
activations.
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

The high-level API: every layer and model is an ``nn.Layer``;
``Model(network, device=None)`` prepares, fits, evaluates, predicts,
saves and loads it over ``io.DataLoader`` (batches staged on the card
by a prefetch thread, forked workers for the host work), scored by
``metric`` and steered by ``callbacks``; ``save``/``load`` write and read
the reference's checkpoint format; ``summary``/``flops`` count a
network; ``quantization`` (QAT, PTQ, int8 layers), ``incubate.asp`` (2:4
sparsity), ``incubate.auto_checkpoint`` (resume after a crash) and
``distribution`` complete it.

Deployment: ``jit.to_static`` runs a function or layer as a program
exported once per input signature (``torch.export``), converting a
tensor ``if``/``while`` into ``torch.cond``/``torch.while_loop``
(``jit.dy2static``); ``jit.save``/``jit.load`` write and read that program
with a dynamic batch, and ``inference.create_predictor`` serves it, from
Python or from C (``capi``).  ``onnx.export`` writes an ONNX file, and
``static`` builds and runs programs of deferred ops (``Program``,
``Executor``, ``optimizer.minimize``).  ``enable_static``/
``disable_static`` set the mode ``in_dynamic_mode`` reports.
"""
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import distributed  # noqa: F401
from . import distribution  # noqa: F401
from . import hapi  # noqa: F401
from . import incubate  # noqa: F401
from . import io  # noqa: F401
from . import metric  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import profiler  # noqa: F401
from . import quantization  # noqa: F401
from . import serving  # noqa: F401
from . import utils  # noqa: F401
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
from .framework.io import load, save  # noqa: F401
from .hapi import Model, callbacks, flops, summary  # noqa: F401
from . import tensor  # noqa: F401
from .tensor import *  # noqa: F401,F403
from .tensor import (TensorArray, array_length, array_read,  # noqa: F401
                     array_write, case, create_array, switch_case, tolist,
                     while_loop)
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


# ``static`` registers the op shim's static-graph bridge when imported, so
# it (with ``onnx`` and ``capi``) is imported at first use, not here
_LAZY_MODULES = ("static", "onnx", "capi")


def __getattr__(name):
    if name in _LAZY_MODULES:
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


_static_mode = False


def disable_static(*args, **kwargs) -> None:
    """Return to dygraph, the default mode."""
    global _static_mode
    _static_mode = False


def enable_static(*args, **kwargs) -> None:
    """Enter static-graph mode: ``in_dynamic_mode`` then reports False.
    ``static`` builds its programs from ``static.data`` placeholders in
    either mode; the flag exists for code written against the
    reference."""
    global _static_mode
    _static_mode = True


def in_dynamic_mode() -> bool:
    """True unless ``enable_static`` is in force (or ``FLAGS_eager_mode``
    is off)."""
    from .core.flags import flag

    return bool(flag("FLAGS_eager_mode")) and not _static_mode
