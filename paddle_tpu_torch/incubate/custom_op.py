"""Custom-op registration: user kernels entering the framework
(counterpart of the reference's ``incubate/custom_op.py``).

The reference wraps a user kernel (a Pallas kernel or any jnp callable)
in ``jax.custom_vjp`` when it comes with a hand-written backward, then in
its dispatch layer so the result is taped.  Here ``forward`` is any
callable on tensors -- a CUDA kernel's wrapper such as
``ops.custom_kernels.scale_mul``, or torch ops -- and a backward makes it a
``torch.autograd.Function``, which torch's autograd tapes like any op and
``TrainStep`` trains through.  The backward runs torch ops on the saved
inputs, so ``create_graph`` differentiates through it, as the reference
differentiates a jnp backward.

The registry is process-global and names are unique, as in the
reference's ``OpInfoMap``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["register_custom_op", "get_custom_op", "registered_custom_ops"]

_REGISTRY: Dict[str, Callable] = {}


def _check_tensors(name: str, args) -> None:
    for i, a in enumerate(args):
        if not torch.is_tensor(a):
            raise InvalidArgumentError(
                "custom op %r takes tensors; argument %d is %s"
                % (name, i, type(a).__name__))


def _with_backward(name: str, forward: Callable, backward: Callable,
                   num_diff_args: Optional[int]) -> Callable:
    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            out = forward(*args)
            ctx.single = torch.is_tensor(out)
            return out

        @staticmethod
        def backward(ctx, *cots):
            residuals = ctx.saved_tensors
            grads = tuple(backward(residuals,
                                   cots[0] if ctx.single else cots))
            expect = len(residuals) if num_diff_args is None \
                else num_diff_args
            if len(grads) != expect:
                raise InvalidArgumentError(
                    "custom op %r backward returned %d cotangents, expected "
                    "%d" % (name, len(grads), expect))
            # the arguments past num_diff_args get zero gradients, as the
            # reference's zeros_like gives
            return grads + tuple(torch.zeros_like(r)
                                 for r in residuals[expect:])

    return Op.apply


def register_custom_op(name: str, forward: Callable,
                       backward: Optional[Callable] = None,
                       num_diff_args: Optional[int] = None) -> Callable:
    """Register ``forward`` as a framework op named ``name``.

    ``forward(*tensors) -> tensor``: the user kernel.
    ``backward(residuals, cotangent) -> tuple(input_cotangents)``: an
    optional hand-written vjp; ``residuals`` are the forward's inputs
    (custom_operator.cc's grad-op convention: a grad kernel receives the
    forward inputs and the output grad).  ``num_diff_args``: how many
    leading arguments are differentiable (all, by default); the rest get
    zero gradients.  Without a backward the output carries no graph.

    Returns the op; :func:`get_custom_op` finds it by name."""
    if not name or not isinstance(name, str):
        raise InvalidArgumentError("custom op needs a non-empty string name")
    if name in _REGISTRY:
        raise InvalidArgumentError(
            "custom op %r already registered; names are unique like the "
            "reference's OpInfoMap" % name)
    if backward is not None:
        kernel = _with_backward(name, forward, backward, num_diff_args)

        def op(*args):
            _check_tensors(name, args)
            return kernel(*args)
    else:
        def op(*args):
            _check_tensors(name, args)
            with torch.no_grad():
                return forward(*args)

    op.__name__ = op.__qualname__ = name
    _REGISTRY[name] = op
    return op


def get_custom_op(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise InvalidArgumentError(
            "no custom op named %r; registered: %s"
            % (name, sorted(_REGISTRY))) from None


def registered_custom_ops() -> Dict[str, Callable]:
    return dict(_REGISTRY)
