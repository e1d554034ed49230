"""``paddle_tpu_torch.autograd``: the engine functions and ``PyLayer``
(counterpart of the reference's ``autograd/__init__.py``).

``PyLayer`` sits on a ``torch.autograd.Function``: the subclass's static
``forward(ctx, *args)`` runs with gradient recording off, and torch calls
its ``backward(ctx, *grads)`` with one gradient per output.  As in the
reference, the backward returns one gradient for each tensor argument
that requires grad, and a PyLayer cannot be differentiated twice:
``grad(..., create_graph=True)`` through one raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ..framework.engine import (backward, enable_grad, grad,  # noqa: F401
                                is_grad_enabled, no_grad, set_grad_enabled)

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext"]


class PyLayerContext:
    """The ``ctx`` handed to ``PyLayer.forward`` and ``backward``."""

    def save_for_backward(self, *tensors):
        self.saved_tensor_list = list(tensors)

    def saved_tensor(self):
        return list(getattr(self, "saved_tensor_list", ()))


class _PyLayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        ctx.layer = layer
        ctx.pyctx = PyLayerContext()
        ctx.diff = [torch.is_tensor(a) and a.requires_grad for a in args]
        return layer.forward(ctx.pyctx, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        # torch runs a Function's backward with recording on exactly when
        # the caller asked for create_graph
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "create_graph=True cannot differentiate through PyLayer %r: "
                "its backward records no re-derivable primal; write it with "
                "regular ops or use incubate.autograd"
                % ctx.layer.__name__)
        got = ctx.layer.backward(ctx.pyctx, *grads)
        got = [got] if torch.is_tensor(got) else list(got)
        if len(got) != sum(ctx.diff):
            raise ValueError(
                "PyLayer.backward returned %d grads for %d differentiable "
                "inputs" % (len(got), sum(ctx.diff)))
        it = iter(got)
        return (None, None) + tuple(next(it) if d else None
                                    for d in ctx.diff)


class PyLayer:
    """Custom-autograd extension point: subclass with static
    ``forward(ctx, *args)`` and ``backward(ctx, *grads)``, then call
    ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):  # pragma: no cover - interface
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):  # pragma: no cover - interface
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)
