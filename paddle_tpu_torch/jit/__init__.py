"""Decode sessions, cache layouts, training steps, and the static side of
``jit``: ``to_static``, ``save``/``load`` and ``InputSpec`` (counterpart of
``paddle_tpu.jit``).

``to_static`` runs a function or a layer as a program that
``torch.export`` traces once per input signature (the shapes, dtypes and
devices of its tensor arguments, the values of its other arguments, the
layers' train/eval modes and whether grad is on) and replays after: the
Python body runs only while a signature is traced.  The layer's
parameters and buffers are inputs of the program, so an optimizer's
update is seen without a retrace, a backward reaches the parameters, and
a buffer written in place (BatchNorm's running statistics) is written back
into the layer's tensor.  Random ops draw from the global generator at
each replay, so dropout advances per call.  A tensor ``if``/``while`` that
the trace cannot decide is converted by ``dy2static`` into ``torch.cond``/
``torch.while_loop`` and traced again, as the reference retries through
its AST pass.

``save`` exports the layer in eval mode with an open batch and writes the
reference's three files with the program in ``torch.export``'s format:

- ``<path>.pdmodel.pt2``: the program (``torch.export.save``);
- ``<path>.pdiparams.npz``: the weights, keyed ``param:<name>`` and
  ``buffer:<name>`` by the reference's names (bf16 arrays as their 16-bit
  patterns, named in the metadata's ``bf16``);
- ``<path>.pdmodel.json``: the reference's metadata keys.

With ``params_const=False`` (the default) the program takes the weights
as inputs, as the reference's ``infer(param_vals, buf_vals, *args)``: they
are stored once, in the ``.npz``, and ``set_state_dict`` on the loaded
layer takes effect.  With ``params_const=True`` the weights live in the
``.pt2``, no ``.npz`` copy is written and the loaded layer refuses
``set_state_dict``.  ``load(path, device=None)`` puts the program on the
card unless the caller asks for the CPU; an artifact saved on either
device loads on either.  The program holds K3 as the registered operator
``paddle_tpu_torch.flash_attention_forward``, which launches the hand
kernel on the card.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.errors import InvalidArgumentError
from ..nn.layer.layers import Layer
from .cache import CACHE_LAYOUTS, RecurrentLayout, get_layout  # noqa: F401
from .decode import DecodeSession, truncate_at_eos  # noqa: F401
from .mesh import DecodeMesh  # noqa: F401
from .speculative import SpeculativeDecodeSession  # noqa: F401
from .train_step import MultiStepTrainStep, TrainStep  # noqa: F401

__all__ = ["to_static", "not_to_static", "StaticFunction", "InputSpec",
           "TrainStep", "MultiStepTrainStep", "DecodeSession", "DecodeMesh",
           "SpeculativeDecodeSession", "save", "load", "TranslatedLayer",
           "ProgramTranslator", "TracedLayer", "set_code_level",
           "set_verbosity", "enable_to_static"]


class InputSpec:
    """An input's signature: ``shape`` (``None`` or -1 for a dimension
    left open, a string for an open dimension shared by name), ``dtype``
    and ``name``; what ``to_static``, ``save``, ``Model(inputs=)`` and
    ``summary`` take."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        from ..core.dtype import convert_dtype

        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype, name=name)

    def __repr__(self):
        return "InputSpec(shape=%s, dtype=%s, name=%s)" % (
            self.shape, self.dtype, self.name)


# -- the traced program -------------------------------------------------------

def _data_dependent_errors() -> tuple:
    """What a trace raises at a Python branch on a traced value."""
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)

    return (GuardOnDataDependentSymNode, DataDependentOutputException)


def _find_layer(fn) -> Optional[torch.nn.Module]:
    owner = getattr(fn, "__self__", None)
    return owner if isinstance(owner, torch.nn.Module) else None


class _Program(torch.nn.Module):
    """``forward(params, buffers, *tensors)``: ``fn`` called with the
    layer's parameters and buffers replaced by the given ones and its
    arguments rebuilt from ``tensors`` and the static leaves."""

    def __init__(self, fn: Callable, layer, spec, leaves: list,
                 mask: List[bool]):
        super().__init__()
        self.fn = fn
        self.__dict__["layer"] = layer  # not a submodule: no state here
        self.spec = spec
        self.leaves = leaves
        self.mask = mask

    def forward(self, params, buffers, *tensors):
        it = iter(tensors)
        leaves = [next(it) if m else leaf
                  for leaf, m in zip(self.leaves, self.mask)]
        args, kwargs = pytree.tree_unflatten(leaves, self.spec)
        if self.layer is None:
            return self.fn(*args, **kwargs)
        from torch.nn.utils.stateless import _reparametrize_module

        with _reparametrize_module(self.layer, {**params, **buffers}):
            return self.fn(*args, **kwargs)


def _export(module: torch.nn.Module, args: tuple, dynamic_shapes=None):
    return torch.export.export(module, args, dynamic_shapes=dynamic_shapes,
                               strict=False)


def _convert(fn):
    """``fn`` through ``dy2static.convert``, bound again to its layer."""
    from . import dy2static

    conv = dy2static.convert(fn)
    owner = getattr(fn, "__self__", None)
    return conv.__get__(owner) if owner is not None else conv


def _export_converting(make_module: Callable, fn: Callable, args: tuple,
                       dynamic_shapes=None):
    """Export ``make_module(fn)``; a branch on a traced value converts
    ``fn`` by ``dy2static`` and exports again.  Returns ``(program,
    fn)`` with the function that traced."""
    from . import dy2static

    errors = _data_dependent_errors()
    try:
        return _export(make_module(fn), args, dynamic_shapes), fn
    except errors as e:
        if getattr(fn, "__dy2static_converted__", False):
            raise RuntimeError(dy2static.hint_for_tracer_error(e, fn)) from e
        try:
            conv = _convert(fn)
        except dy2static.ConversionError as ce:
            raise RuntimeError(
                dy2static.hint_for_tracer_error(e, fn)
                + " (auto-conversion: %s)" % ce) from e
        try:
            return _export(make_module(conv), args, dynamic_shapes), conv
        except errors as e2:
            raise RuntimeError(
                dy2static.hint_for_tracer_error(e2, conv)) from e2


def _state(layer):
    if layer is None:
        return {}, {}
    return dict(layer.named_parameters()), dict(layer.named_buffers())


def _hashable(v):
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


class StaticFunction:
    """A function or layer run as programs traced once per signature (the
    reference's ``StaticFunction``; module docstring)."""

    def __init__(self, function: Callable, input_spec=None):
        if isinstance(function, torch.nn.Module):
            self._layer = function
            self._function = function.forward
        else:
            self._layer = _find_layer(function)
            self._function = function
        self._input_spec = input_spec
        self._programs: Dict[Any, Any] = {}
        # what traces: the function, or its dy2static conversion once a
        # trace needed one (ProgramTranslator's eager path keeps the
        # original)
        self._traced_fn = self._function
        functools.update_wrapper(self, self._function)

    def __get__(self, instance, owner=None):
        """``@to_static`` on a method: each instance gets its own bound
        function and its own programs."""
        if instance is None:
            return self
        cache = instance.__dict__.setdefault("_static_fn_cache", {})
        if id(self) not in cache:
            bound = StaticFunction(self._function.__get__(instance, owner),
                                   self._input_spec)
            cache[id(self)] = bound
        return cache[id(self)]

    def _key(self, spec, leaves, mask):
        layers = self._layer.modules() if self._layer is not None else ()
        return (spec, tuple(
            (tuple(l.shape), l.dtype, l.device) if m else _hashable(l)
            for l, m in zip(leaves, mask)),
            tuple(m.training for m in layers), torch.is_grad_enabled())

    def __call__(self, *args, **kwargs):
        if not ProgramTranslator._enabled:
            return self._function(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        leaves = [torch.from_numpy(l) if isinstance(l, np.ndarray) else l
                  for l in leaves]
        mask = [torch.is_tensor(l) for l in leaves]
        tensors = tuple(l for l, m in zip(leaves, mask) if m)
        params, buffers = _state(self._layer)
        key = self._key(spec, leaves, mask)
        program = self._programs.get(key)
        if program is None:
            static = [None if m else l for l, m in zip(leaves, mask)]
            example = tuple(t.detach() for t in tensors)
            ep, self._traced_fn = _export_converting(
                lambda f: _Program(f, self._layer, spec, static, mask),
                self._traced_fn,
                ({n: p.detach() for n, p in params.items()}, buffers)
                + example)
            program = self._programs[key] = ep.module()
        return program(params, buffers, *tensors)

    @property
    def concrete_program(self):
        """The programs traced so far, by signature."""
        return dict(self._programs)

    def rollback(self):
        return self._function


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """``@to_static``: run ``function`` (or a layer) as traced programs."""

    def decorate(fn):
        return StaticFunction(fn, input_spec=input_spec)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn=None):
    """Every function traces; nothing needs excluding."""
    return fn


# -- save / load ----------------------------------------------------------------

_ARTIFACT_SUFFIX = ".pdmodel.pt2"
_PARAMS_SUFFIX = ".pdiparams.npz"
_META_SUFFIX = ".pdmodel.json"
_OPEN_EXAMPLE = 2  # export specializes sizes 0 and 1: an open axis traces at 2


def _specs_from_input_spec(input_spec, device):
    """Example tensors and ``dynamic_shapes`` for ``input_spec``: a
    ``None``/-1 at axis 0 is the shared batch dimension, another open axis
    gets its own, and a string names a dimension shared by name.  A tensor
    in ``input_spec`` is an example of fixed shape."""
    from torch.export import Dim

    dims: Dict[str, Any] = {}

    def dim(name):
        if name not in dims:
            dims[name] = Dim(name, min=1)
        return dims[name]

    examples, dynamic = [], []
    for j, spec in enumerate(input_spec):
        if torch.is_tensor(spec) or isinstance(spec, np.ndarray):
            t = torch.as_tensor(spec)
            examples.append(t.to(device))
            dynamic.append(None)
            continue
        shape, axes = [], {}
        for i, d in enumerate(spec.shape):
            if isinstance(d, str):
                axes[i] = dim(d)
            elif d is None or d < 0:
                axes[i] = dim("batch" if i == 0 else "d%d_%d" % (j, i))
            if i in axes:
                shape.append(_OPEN_EXAMPLE)
            else:
                shape.append(int(d))
        examples.append(torch.zeros(shape, dtype=spec.dtype, device=device))
        dynamic.append(axes or None)
    return tuple(examples), tuple(dynamic)


class _Bound(torch.nn.Module):
    """``fn`` of ``layer`` with the layer's weights as module state: what
    ``params_const=True`` exports, so the weights live in the program."""

    def __init__(self, fn, layer):
        super().__init__()
        self.fn = fn
        if layer is not None:
            self.layer = layer

    def forward(self, *args):
        return self.fn(*args)


def _to_numpy(t: torch.Tensor):
    """``(array, is_bf16)``: numpy has no bfloat16, so a bf16 tensor is
    stored as its 16-bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), True
    return t.numpy(), False


def _from_numpy(a, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def save(layer, path: str, input_spec=None, **config) -> None:
    """Write ``layer`` (a layer, a :class:`StaticFunction` or a layer's
    method) as a program with an open batch (module docstring).
    ``params_const=True`` puts the weights in the program."""
    if isinstance(layer, StaticFunction):
        fn, owner = layer._function, layer._layer
        if input_spec is None:
            input_spec = layer._input_spec
    elif isinstance(layer, torch.nn.Module):
        fn, owner = layer.forward, layer
    elif callable(layer):
        fn, owner = layer, _find_layer(layer)
    else:
        raise InvalidArgumentError(
            "jit.save expects a Layer or function, got %r" % type(layer))
    if input_spec is None:
        raise InvalidArgumentError(
            "jit.save requires input_spec=[InputSpec(shape, dtype), ...] "
            "(or example Tensors) to fix the traced signature")
    params_const = bool(config.pop("params_const", False))
    params, buffers = _state(owner)
    device = next(iter(list(params.values()) + list(buffers.values())),
                  torch.empty(0)).device
    examples, dynamic = _specs_from_input_spec(input_spec, device)
    was_training = [m.training for m in owner.modules()] if owner else []
    if owner is not None:
        owner.eval()
    try:
        with torch.no_grad():
            if params_const:
                ep, _ = _export_converting(
                    lambda f: _Bound(f, owner), fn, examples, (dynamic,))
            else:
                n = len(examples)
                ep, _ = _export_converting(
                    lambda f: _Program(f, owner, pytree.tree_flatten(
                        (tuple(range(n)), {}))[1], [None] * n, [True] * n),
                    fn, (params, buffers) + examples,
                    # the *tensors group takes its dimensions as one tuple
                    ({k: None for k in params}, {k: None for k in buffers},
                     dynamic))
    finally:
        if owner is not None:
            for m, t in zip(owner.modules(), was_training):
                m.training = t
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.export.save(ep, path + _ARTIFACT_SUFFIX)
    arrays, bf16 = {}, []
    if not params_const:  # the weights live in the program otherwise
        for kind, named in (("param:", params), ("buffer:", buffers)):
            for name, t in named.items():
                arrays[kind + name], is_bf16 = _to_numpy(t)
                if is_bf16:
                    bf16.append(kind + name)
    np.savez(path + _PARAMS_SUFFIX, **arrays)
    meta = {
        "format": "paddle_tpu_torch.jit/1",
        "platforms": ["cpu", "cuda"],
        "param_names": list(params) if not params_const else [],
        "buffer_names": list(buffers) if not params_const else [],
        "n_inputs": len(examples),
        "params_const": params_const,
        "device": device.type,
        "bf16": bf16,
    }
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f)


def _resolve(device) -> torch.device:
    from ..core.device import resolve_device

    return resolve_device(device)


class TranslatedLayer(Layer):
    """A loaded artifact, callable like a layer; inference only."""

    def __init__(self, program, param_arrays, buffer_arrays, meta, device):
        super().__init__()
        self._program = program
        self._meta = meta
        self._device = device
        # not a submodule: the weights of a params_const program stay out
        # of this layer's state
        self.__dict__["_module"] = program.module()
        self._param_keys: List[str] = []
        self._buffer_keys: List[str] = []
        if meta.get("params_const"):
            return  # the weights live in the program
        bf16 = set(meta.get("bf16", ()))
        for kind, names, arrays in (("param:", meta["param_names"],
                                     param_arrays),
                                    ("buffer:", meta["buffer_names"],
                                     buffer_arrays)):
            for name, a in zip(names, arrays):
                t = _from_numpy(a, kind + name in bf16, device)
                key = name.replace(".", "__")
                if kind == "param:":
                    self.register_parameter(
                        key, torch.nn.Parameter(t, requires_grad=False))
                    self._param_keys.append(key)
                else:
                    self.register_buffer(key, t)
                    self._buffer_keys.append(key)

    @property
    def in_specs(self) -> list:
        """The program's input placeholders (weights included)."""
        return [s for s in self._program.graph_signature.input_specs]

    @torch.no_grad()
    def forward(self, *args):
        args = tuple(torch.as_tensor(a).to(self._device) for a in args)
        if self._meta.get("params_const"):
            return self._module(*args)
        # the live tensors, so set_state_dict takes effect
        params = {n: getattr(self, k) for n, k in zip(
            self._meta["param_names"], self._param_keys)}
        buffers = {n: getattr(self, k) for n, k in zip(
            self._meta["buffer_names"], self._buffer_keys)}
        return self._module(params, buffers, *args)

    def set_state_dict(self, state_dict, *args, **kwargs):
        if self._meta.get("params_const"):
            raise InvalidArgumentError(
                "this artifact was saved with params_const=True: its "
                "weights are program constants and cannot be retargeted; "
                "re-export with params_const=False for a swappable-weights "
                "artifact")
        return super().set_state_dict(state_dict, *args, **kwargs)

    # the base class binds these to its own set_state_dict, which would
    # pass by the guard above
    set_dict = set_state_dict
    load_dict = set_state_dict


def load(path: str, device=None, **config) -> TranslatedLayer:
    """Load a :func:`save` artifact onto ``device`` (None: the card, which
    raises without one; ``"cpu"`` on the CPU)."""
    dev = _resolve(device)
    with open(path + _META_SUFFIX) as f:
        meta = json.load(f)
    # the operators a program may hold are registered on import
    from ..ops import flash_kernels  # noqa: F401

    program = torch.export.load(path + _ARTIFACT_SUFFIX)
    if meta.get("device") != dev.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    params, buffers = [], []
    if not meta.get("params_const"):
        data = np.load(path + _PARAMS_SUFFIX)
        params = [data["param:" + n] for n in meta["param_names"]]
        buffers = [data["buffer:" + n] for n in meta["buffer_names"]]
    return TranslatedLayer(program, params, buffers, meta, dev)


def set_code_level(level: int = 100, also_to_stdout: bool = False) -> None:
    """Accepted for the reference's debugging API: the converted source is
    not printed."""


def set_verbosity(level: int = 0, also_to_stdout: bool = False) -> None:
    """Accepted for the reference's debugging API (see set_code_level)."""


class ProgramTranslator:
    """The global switch: ``enable(False)`` runs ``to_static`` functions
    eagerly."""

    _instance = None
    _enabled = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool) -> None:
        type(self)._enabled = bool(enable_to_static)

    @property
    def enable_to_static(self) -> bool:
        return type(self)._enabled


def enable_to_static(enable: bool = True) -> None:
    """Turn ``to_static`` on or off for the process."""
    ProgramTranslator.get_instance().enable(enable)


class TracedLayer:
    """Trace a layer once with example inputs, then run or save the
    traced program."""

    def __init__(self, static_fn, examples):
        self._fn = static_fn
        self._examples = examples

    @classmethod
    def trace(cls, layer, inputs):
        inputs = list(inputs)
        fn = to_static(layer)
        out = fn(*inputs)
        return out, cls(fn, inputs)

    def __call__(self, *args):
        return self._fn(*args)

    def save_inference_model(self, path, feed=None, fetch=None):
        specs = [InputSpec.from_tensor(t) if torch.is_tensor(t) else t
                 for t in self._examples]
        save(self._fn, path, input_spec=specs)
