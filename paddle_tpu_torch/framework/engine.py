"""The eager grad engine's surface (counterpart of the reference's
``framework/engine.py``): ``backward``, ``grad`` and the grad-mode
switches.

The reference records a tape of ``GradNode``s over its Tensor facade and
sweeps it; here torch's autograd graph *is* the tape, so there is no node
class and no sweep.  What stays is paddle's semantics where torch's
differ:

- ``grad(retain_graph=None)`` means ``retain_graph=create_graph``;
- a missing ``grad_outputs`` entry is ``ones_like`` the output, for
  non-scalar outputs too (torch refuses to make those implicitly);
- an input the outputs do not reach raises :class:`InvalidArgumentError`
  ("appears unused") unless ``allow_unused=True``;
- a single tensor in gives a single tensor out;
- a second backward through a freed graph raises
  :class:`InvalidArgumentError`, translated from torch's ``RuntimeError``.

Paddle's ``stop_gradient`` is torch's ``not requires_grad``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["is_grad_enabled", "set_grad_enabled", "no_grad", "enable_grad",
           "backward", "grad"]

# paddle.no_grad / paddle.enable_grad: context managers and decorators
no_grad = torch.no_grad
enable_grad = torch.enable_grad


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> None:
    """Switch gradient recording on or off for this thread."""
    torch.set_grad_enabled(bool(mode))


@contextlib.contextmanager
def _typed_freed_graph_error():
    try:
        yield
    except RuntimeError as e:
        if "second time" not in str(e):
            raise
        raise InvalidArgumentError(
            "Trying to backward through the graph a second time; the saved "
            "intermediate results have been freed. Specify retain_graph=True "
            "on the first backward call.") from e


def _as_list(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """paddle.autograd.backward: accumulate into ``.grad`` of every leaf
    the ``tensors`` reach.  A non-scalar tensor needs its grad tensor."""
    tensors = _as_list(tensors)
    grad_tensors = [None] * len(tensors) if grad_tensors is None \
        else _as_list(grad_tensors)
    seeds = []
    for t, g in zip(tensors, grad_tensors):
        if not t.requires_grad:
            raise InvalidArgumentError(
                "backward() called on a tensor with stop_gradient=True and no "
                "recorded graph; nothing to differentiate")
        if g is None:
            if t.numel() != 1:
                raise InvalidArgumentError(
                    "grad can be implicitly created only for scalar outputs; "
                    "got shape %s. Pass grad_tensors explicitly."
                    % (list(t.shape),))
            g = torch.ones_like(t)
        seeds.append(g)
    with _typed_freed_graph_error():
        torch.autograd.backward(tensors, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None,
         retain_graph: Optional[bool] = None, create_graph: bool = False,
         only_inputs: bool = True, allow_unused: bool = False,
         no_grad_vars=None):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs``, returned rather than accumulated into ``.grad``.

    ``create_graph=True`` returns gradients that carry their own graph, so
    grad-of-grad composes to any order.  ``only_inputs`` and
    ``no_grad_vars`` are accepted and, as in the reference, have no
    effect."""
    single_in = isinstance(inputs, torch.Tensor)
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    grad_outputs = [None] * len(outputs) if grad_outputs is None \
        else _as_list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph  # double grad walks the graph again
    pairs = [(t, torch.ones_like(t) if g is None else g)
             for t, g in zip(outputs, grad_outputs) if t.requires_grad]
    wanted = [i for i, t in enumerate(inputs) if t.requires_grad]
    results = [None] * len(inputs)
    if pairs and wanted:
        with _typed_freed_graph_error():
            got = torch.autograd.grad(
                [t for t, _ in pairs], [inputs[i] for i in wanted],
                [g for _, g in pairs], retain_graph=retain_graph,
                create_graph=create_graph, allow_unused=True)
        for i, g in zip(wanted, got):
            results[i] = g
    if not allow_unused and any(g is None for g in results):
        raise InvalidArgumentError(
            "One of the differentiated tensors appears unused in the graph. "
            "Set allow_unused=True to return None for it.")
    return results[0] if single_in else results
