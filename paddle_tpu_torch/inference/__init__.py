"""The deployment predictor and continuous batching (counterpart of
``paddle_tpu.inference``).

The predictor serves a ``jit.save`` artifact: ``Config(prefix)`` names it,
``create_predictor`` loads the program with ``jit.load`` and ``run`` calls
it.  Handles follow the reference's (``get_input_handle(name)
.copy_from_cpu(array)``, ``run()``, ``get_output_handle(name)
.copy_to_cpu()``), or ``run([arrays])`` returns the outputs as arrays.
``copy_from_cpu`` stages an array onto the predictor's device (pinned and
non-blocking on the card), ``run`` calls the program on the current stream
and ``copy_to_cpu`` synchronizes by reading the result back.

A ``Config`` runs on the card unless ``disable_gpu()`` is called; unlike
the reference's it does not fall back to the CPU when no card is found:
without CUDA, ``create_predictor`` raises ``UnavailableError``.

Generation is served by ``GenerationPool`` and ``SpeculativePool``, which
own a live model (the artifact is a fixed program without a cache).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from .generation import (DuplicateRequestError, GenerationPool,  # noqa: F401
                         kv_reachable_bytes)
from .speculative import SpeculativePool  # noqa: F401

__all__ = ["Config", "Predictor", "PredictorTensor", "Tensor",
           "create_predictor", "PredictorPool", "get_version",
           "DataType", "PlaceType", "PrecisionType",
           "get_num_bytes_of_data_type", "GenerationPool",
           "create_generation_pool", "kv_reachable_bytes",
           "DuplicateRequestError", "SpeculativePool"]

VERSION = "0.1.0"


class DataType:
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    INT8 = "int8"
    BOOL = "bool"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"
    XPU = "xpu"


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


def get_num_bytes_of_data_type(dtype) -> int:
    """Bytes of one element of ``dtype`` (a name or a ``DataType``)."""
    if str(dtype) == "bfloat16":
        return 2
    return np.dtype(dtype).itemsize


def get_version() -> str:
    return "paddle_tpu_torch inference %s" % VERSION


class Config:
    """The predictor's configuration: the artifact prefix and the device
    (the card unless ``disable_gpu()``); the reference's other knobs are
    stored and reported."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # Config(model_dir) or Config(prog, params): one jit.save prefix
        # covers both files
        self._model_prefix = prog_file
        self._params_file = params_file
        self._device = "cuda"
        self._device_id = 0
        self._enable_memory_optim = True
        self._switch_ir_optim = True

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self._model_prefix = prog_file
        self._params_file = params_file

    def model_dir(self) -> Optional[str]:
        return self._model_prefix

    def prog_file(self) -> Optional[str]:
        return self._model_prefix

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._device = "cuda"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device == "cuda"

    def device(self) -> str:
        """The device the predictor runs on (``"cuda:<id>"`` or
        ``"cpu"``)."""
        return "cpu" if self._device == "cpu" \
            else "cuda:%d" % self._device_id

    def enable_memory_optim(self):
        self._enable_memory_optim = True

    def switch_ir_optim(self, x: bool = True):
        """Stored; ``jit.save(..., params_const=True)`` is the save-time
        analog of the reference's constant-folding passes."""
        self._switch_ir_optim = x

    def set_cpu_math_library_num_threads(self, n: int):
        self._cpu_threads = n

    def summary(self) -> str:
        return "Config(model=%r, device=%s)" % (self._model_prefix,
                                                self.device())


class PredictorTensor:
    """An input or output handle: staged host to device and back."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self._device = device
        self._value: Optional[torch.Tensor] = None

    def reshape(self, shape):
        """Accepted for the reference's API: the shape comes with the
        array given to ``copy_from_cpu``."""

    def copy_from_cpu(self, data) -> None:
        a = np.ascontiguousarray(data)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        if self._device.type == "cuda":
            t = t.pin_memory().to(self._device, non_blocking=True)
        self._value = t

    def share_external_data(self, data) -> None:
        self._value = torch.as_tensor(data, device=self._device)

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise InvalidArgumentError(
                "output %r not computed yet; Run() first" % self.name)
        out = self._value.detach().cpu()  # waits for the card
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.numpy()

    def shape(self):
        return list(self._value.shape) if self._value is not None else None

    def type(self):
        if self._value is None:
            return None
        return str(self._value.dtype).replace("torch.", "")


Tensor = PredictorTensor


def _leaves(out) -> list:
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return []


class Predictor:
    """Serves a ``jit.save`` artifact on the config's device."""

    def __init__(self, config: Config):
        from ..core.device import resolve_device
        from ..jit import load as jit_load

        prefix = config.model_dir()
        if prefix is None:
            raise InvalidArgumentError("Config has no model set")
        if not os.path.exists(prefix + ".pdmodel.json"):
            raise InvalidArgumentError(
                "no artifact at %r (expected jit.save output: "
                "<prefix>.pdmodel.pt2 + .pdiparams.npz + .pdmodel.json)"
                % prefix)
        self._device = resolve_device(config.device())
        self._layer = jit_load(prefix, device=self._device)
        n_in = self._layer._meta.get("n_inputs", 1)
        self._input_names = ["input_%d" % i for i in range(n_in)]
        self._inputs = {n: PredictorTensor(n, self._device)
                        for n in self._input_names}
        self._output_names: List[str] = []
        self._outputs: Dict[str, PredictorTensor] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        if name not in self._inputs:
            raise InvalidArgumentError("unknown input %r (have %s)"
                                       % (name, self._input_names))
        return self._inputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """``run([arrays])`` returns the outputs as arrays; ``run()``
        after ``copy_from_cpu`` fills the output handles and returns
        True."""
        if inputs is not None:
            if len(inputs) != len(self._input_names):
                raise InvalidArgumentError(
                    "the program takes %d inputs, got %d"
                    % (len(self._input_names), len(inputs)))
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(np.asarray(a))
        missing = [n for n in self._input_names
                   if self._inputs[n]._value is None]
        if missing:
            raise InvalidArgumentError(
                "inputs %s not set; copy_from_cpu first" % missing)
        out = self._layer(*[self._inputs[n]._value
                            for n in self._input_names])
        leaves = _leaves(out)
        self._output_names = ["output_%d" % i for i in range(len(leaves))]
        self._outputs = {}
        for n, v in zip(self._output_names, leaves):
            h = PredictorTensor(n, self._device)
            h._value = v
            self._outputs[n] = h
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs.values()]
        return True

    Run = run

    def get_output_names(self) -> List[str]:
        if not self._output_names:
            return ["output_0"]
        return list(self._output_names)

    def get_output_handle(self, name: str) -> PredictorTensor:
        if name not in self._outputs:
            raise InvalidArgumentError(
                "output %r not available; call run() first" % name)
        return self._outputs[name]

    def try_shrink_memory(self):
        if self._device.type == "cuda":
            torch.cuda.empty_cache()

    def clear_intermediate_tensor(self):
        """Accepted: the program keeps no intermediates between calls."""


def create_predictor(config: Config) -> Predictor:
    """A :class:`Predictor` over ``config``'s artifact."""
    return Predictor(config)


class PredictorPool:
    """``size`` predictors over one artifact."""

    def __init__(self, config: Config, size: int = 1):
        self._predictors = [Predictor(config) for _ in range(max(1, size))]

    def retrieve(self, idx: int) -> Predictor:
        if not 0 <= idx < len(self._predictors):
            raise InvalidArgumentError(
                "PredictorPool index %d out of range [0, %d)"
                % (idx, len(self._predictors)))
        return self._predictors[idx]


def create_generation_pool(model, max_len: int, **kwargs) -> GenerationPool:
    """A :class:`GenerationPool` over a live cached-decode model: the
    serving analog of ``create_predictor`` for autoregressive
    generation."""
    return GenerationPool(model, max_len, **kwargs)
