"""``Layer``, ``ParamAttr`` and ``create_parameter`` (counterpart of the
reference's ``nn/layer/layers.py``).

:class:`Layer` is a ``torch.nn.Module`` with paddle's surface on top:
``create_parameter``/``add_parameter``/``add_sublayer``,
``register_buffer(persistable=)``, ``sublayers``/``named_sublayers``,
``parameters(include_sublayers=)`` as a list, ``state_dict`` of the
parameters and then the persistable buffers (the reference's order and
keys), ``set_state_dict`` returning ``(missing, unexpected)``,
``register_forward_pre_hook``/``register_forward_post_hook``,
``clear_gradients``, ``astype``, ``full_name`` and ``to(device=, dtype=,
blocking=)`` with paddle's places (``"gpu"``, ``"gpu:N"``).  Torch's own
signatures keep working beside them (``parameters(recurse=)``,
``named_parameters(prefix, recurse, remove_duplicate)``,
``state_dict(destination, prefix, keep_vars)``, ``to(*args)``,
``register_buffer(persistent=)``), because torch calls them.  Every
layer and model of the port derives from it.

What the reference's ``Layer.create_parameter`` does is
:func:`create_parameter` here, which makes an ``nn.Parameter`` and sets
the attributes the port's optimizers read where the reference's read
them on its ``Parameter``:

- ``learning_rate`` -> ``p.optimize_attr = {"learning_rate": ratio}``;
- ``regularizer`` -> ``p.regularizer`` (which also makes a sparse
  embedding's update dense, as in the reference);
- ``need_clip`` -> ``p.need_clip``; ``do_model_average`` ->
  ``p.do_model_average``;
- ``trainable=False`` -> ``requires_grad=False``: ``TrainStep`` and the
  optimizers leave the parameter out;
- ``name`` -> ``p.param_name`` (the optimizer's name of it;
  ``torch.Tensor.name`` is torch's), else ``param_<n>`` from the
  process-wide counter, as every parameter a ``Layer`` registers.

An attr of ``False`` (``bias_attr=False``) means no parameter: None.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.dtype import convert_dtype, dtype_name
from ...core.errors import InvalidArgumentError
from ...utils import unique_name
from .. import initializer as I

__all__ = ["ParamAttr", "create_parameter", "Layer", "HookRemoveHelper"]


class ParamAttr:
    """paddle.ParamAttr (fluid/param_attr.py)."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr) -> Optional["ParamAttr"]:
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return None
        raise InvalidArgumentError("unsupported param_attr: %r" % (attr,))


def create_parameter(shape, attr=None, dtype=None, is_bias: bool = False,
                     default_initializer=None, device=None,
                     generator: Optional[torch.Generator] = None
                     ) -> Optional[nn.Parameter]:
    """The reference's ``Layer.create_parameter``: a parameter of
    ``shape`` from ``attr``'s initializer, else ``default_initializer``,
    else zeros for a bias and XavierUniform otherwise, drawn from
    ``generator`` on ``device``; None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is None:
        return None
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    with torch.no_grad():
        value = init(tuple(int(s) for s in shape), dtype, device=device,
                     generator=generator)
    p = nn.Parameter(value, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.do_model_average = attr.do_model_average
    p.need_clip = attr.need_clip
    p.param_name = attr.name if attr.name is not None \
        else unique_name.parameter_name()
    return p


class HookRemoveHelper:
    """The handle a hook registration returns: ``remove()`` takes the hook
    off (over torch's ``RemovableHandle``)."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self) -> None:
        self._handle.remove()


def _place(device) -> Optional[torch.device]:
    """A paddle place (``"gpu"``, ``"gpu:1"``, ``"cpu"``) or a torch
    device as a resolved ``torch.device``."""
    from ...core.device import resolve_device

    if device is None:
        return None
    if isinstance(device, str):
        device = device.lower()
        if device == "gpu" or device.startswith("gpu:"):
            device = "cuda" + device[3:]
    return resolve_device(device)


def _is_dtype(x) -> bool:
    if isinstance(x, torch.dtype):
        return True
    if isinstance(x, str):
        try:
            convert_dtype(x)
        except InvalidArgumentError:
            return False
        return True
    return False


class Layer(nn.Module):
    """paddle.nn.Layer over ``torch.nn.Module`` (the reference's
    ``Layer``, ``nn/layer/layers.py:71``)."""

    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        # paddle's Layer._dtype is a name ("float32")
        self._dtype = dtype_name(dtype) if dtype is not None else "float32"
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction helpers ---------------------------------------------
    def _layer_device(self) -> torch.device:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        return torch.device("cpu")

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None):
        """A parameter made by :func:`create_parameter` on the layer's
        device (that of its first parameter or buffer, else the CPU) in
        the layer's dtype unless ``dtype`` is given; not registered
        (assign it to an attribute, or ``add_parameter``)."""
        return create_parameter(shape, attr=attr,
                                dtype=dtype or self._dtype, is_bias=is_bias,
                                default_initializer=default_initializer,
                                device=self._layer_device())

    def create_tensor(self, name=None, dtype=None, fill_value=0.0):
        return torch.full((), fill_value,
                          dtype=convert_dtype(dtype or self._dtype),
                          device=self._layer_device())

    def register_parameter(self, name: str, param) -> None:
        super().register_parameter(name, param)
        if param is not None and getattr(param, "param_name", None) is None:
            param.param_name = unique_name.parameter_name()

    def add_parameter(self, name: str, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise InvalidArgumentError(
                "add_parameter expects a Parameter, got %r"
                % type(parameter))
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        if not isinstance(sublayer, nn.Module):
            raise InvalidArgumentError(
                "add_sublayer expects a Layer, got %r" % type(sublayer))
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None) -> None:
        """``persistable`` (paddle's) or ``persistent`` (torch's): False
        leaves the buffer out of :meth:`state_dict`."""
        if tensor is not None and not torch.is_tensor(tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)

    # -- iteration ----------------------------------------------------------
    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> list:
        """The parameters (each once), as a list."""
        rec = include_sublayers if recurse is None else recurse
        return [p for _, p in super().named_parameters(recurse=rec)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True,
                         recurse: Optional[bool] = None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=rec,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True,
                recurse: Optional[bool] = None) -> list:
        rec = include_sublayers if recurse is None else recurse
        return [b for _, b in super().named_buffers(recurse=rec)]

    def named_buffers(self, prefix: str = "",
                      include_sublayers: bool = True,
                      remove_duplicate: bool = True,
                      recurse: Optional[bool] = None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=rec,
                                     remove_duplicate=remove_duplicate)

    def named_sublayers(self, prefix: str = "",
                        include_self: bool = False):
        """``(name, layer)`` of every sublayer depth first, each once
        (``include_self``: this layer first, named ``prefix``)."""
        it = self.named_modules(prefix=prefix)
        if not include_self:
            next(it)
        return it

    def sublayers(self, include_self: bool = False) -> list:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # -- state dict ---------------------------------------------------------
    def _persistable_buffers(self, include_sublayers: bool):
        layers = self.named_modules() if include_sublayers \
            else [("", self)]
        seen = set()
        for lname, layer in layers:
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set \
                        or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (lname + "." + bname if lname else bname), b

    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   prefix: str = "", keep_vars: bool = False):
        """The parameters, then the persistable buffers, keyed by their
        structured names (the reference's keys and order); detached
        tensors sharing storage unless ``keep_vars``.  ``prefix`` and
        ``keep_vars`` are torch's (a torch parent's ``state_dict`` passes
        them)."""
        dest = destination if destination is not None \
            else collections.OrderedDict()
        pre = structured_name_prefix + prefix
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[pre + name] = p if keep_vars else p.detach()
        for name, b in self._persistable_buffers(include_sublayers):
            dest[pre + name] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy each entry into the parameter or buffer of its name, in
        place and cast to its dtype; returns ``(missing, unexpected)``
        key lists.  A shape mismatch raises before anything is copied."""
        # the class's walk: an instance-level state_dict (amp.decorate's
        # save_dtype) must not redirect the copies to casted copies
        own = Layer.state_dict(self, keep_vars=True)
        unexpected = [k for k in state_dict if k not in own]
        pairs = []
        for key, value in state_dict.items():
            if key not in own:
                continue
            target = own[key]
            v = value if torch.is_tensor(value) \
                else torch.as_tensor(np.asarray(value))
            if tuple(v.shape) != tuple(target.shape):
                raise InvalidArgumentError(
                    "state_dict shape mismatch for %s: %s vs %s"
                    % (key, tuple(v.shape), tuple(target.shape)))
            pairs.append((target, v))
        with torch.no_grad():
            for target, v in pairs:
                target.copy_(v.to(device=target.device, dtype=target.dtype))
        loaded = set(state_dict)
        missing = [k for k in own if k not in loaded]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype and place ----------------------------------------------------
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` with paddle's
        places and dtype names, or torch's ``to(*args, **kwargs)``."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        blocking = kwargs.pop("blocking", None)
        non_blocking = kwargs.pop("non_blocking",
                                  False if blocking is None else not blocking)
        if kwargs:
            raise InvalidArgumentError(
                "Layer.to: unexpected arguments %r" % sorted(kwargs))
        for a in args:
            if torch.is_tensor(a):
                device, dtype = a.device, a.dtype
            elif _is_dtype(a):
                dtype = a
            else:
                device = a
        device = _place(device)
        dtype = convert_dtype(dtype) if dtype is not None else None
        super().to(device=device, dtype=dtype, non_blocking=non_blocking)
        if dtype is not None:
            for layer in self.modules():
                if isinstance(layer, Layer):
                    layer._dtype = dtype_name(dtype)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs)``; a non-None result replaces the
        inputs."""
        return HookRemoveHelper(super().register_forward_pre_hook(hook))

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)``; a non-None result replaces
        the outputs."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    # -- misc ---------------------------------------------------------------
    def full_name(self) -> str:
        return self._name_scope

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None
