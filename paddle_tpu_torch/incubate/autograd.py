"""Functional higher-order autodiff (counterpart of the reference's
``incubate/autograd.py``): ``jvp``, ``vjp``, ``grad``, ``hvp``,
``Jacobian`` and ``Hessian``.

The reference builds these from JAX's function transforms.  Here they are
built from ``torch.autograd.grad`` and ``torch.autograd.functional`` --
not from ``torch.func``, whose transforms need a vmap rule for every
``autograd.Function`` on the way (a custom op's CUDA kernel has none);
plain autograd goes through every custom op as it is.  ``jvp`` is the
double-vjp construction: it holds on plain functions, and may succeed
through a custom op where JAX refuses forward mode through a
``custom_vjp``.

Results are detached, as the reference returns ``stop_gradient``
tensors, except inside another transform: ``grad`` given an input that
already requires grad keeps its result on that graph, so ``grad`` of
``grad`` composes to any order.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch
from torch.autograd import functional as AF

from ..core.errors import InvalidArgumentError

__all__ = ["jvp", "vjp", "grad", "Jacobian", "Hessian", "hvp"]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _detach(x):
    if isinstance(x, tuple):
        return tuple(_detach(v) for v in x)
    return x.detach()


def jvp(func: Callable, xs, v=None):
    """Forward mode: ``(func(*xs), J v)``; ``v`` defaults to ones."""
    xs_t = _as_tuple(xs)
    v_t = tuple(torch.ones_like(x) for x in xs_t) if v is None \
        else _as_tuple(v)
    out, jv = AF.jvp(func, xs_t, v_t)
    return _detach(out), _detach(jv)


def vjp(func: Callable, xs, v=None):
    """Reverse mode: ``(func(*xs), v^T J)``; ``v`` defaults to ones like
    the output, and a single input gives a single gradient."""
    xs_t = tuple(x.detach().requires_grad_() for x in _as_tuple(xs))
    with torch.enable_grad():
        out = func(*xs_t)
        outs = _as_tuple(out)
        v_t = tuple(torch.ones_like(o) for o in outs) if v is None \
            else _as_tuple(v)
        grads = torch.autograd.grad(outs, xs_t, v_t, allow_unused=True)
    grads = tuple(torch.zeros_like(x) if g is None else g
                  for g, x in zip(grads, xs_t))
    return _detach(out), grads[0] if len(xs_t) == 1 else grads


def grad(func: Callable, argnums: Union[int, Sequence[int]] = 0,
         has_aux: bool = False) -> Callable:
    """The gradient of a scalar function, as a function; composes to any
    order (``grad(lambda x: grad(f)(x).sum())``).  ``argnums`` picks the
    arguments (an int gives one gradient, a sequence a tuple);
    ``has_aux`` means ``func`` returns ``(value, aux)`` and the result is
    ``(gradient, aux)``."""
    nums = _as_tuple(argnums)

    def wrapped(*xs):
        # an input already on a graph stays on it: an enclosing transform
        # then differentiates through this one
        nested = any(torch.is_tensor(x) and x.requires_grad for x in xs)
        xs = list(xs)
        for i in nums:
            if not xs[i].requires_grad:
                xs[i] = xs[i].detach().requires_grad_()
        with torch.enable_grad():
            res = func(*xs)
            out, aux = res if has_aux else (res, None)
            if out.numel() != 1:
                raise InvalidArgumentError(
                    "incubate.autograd.grad needs a scalar output, got shape "
                    "%s" % (list(out.shape),))
            wrt = [xs[i] for i in nums]
            got = torch.autograd.grad(out, wrt, create_graph=nested,
                                      allow_unused=True)
        got = tuple(torch.zeros_like(w) if g is None else g
                    for g, w in zip(got, wrt))
        if not nested:
            got = _detach(got)
        got = got[0] if isinstance(argnums, int) else got
        return (got, aux) if has_aux else got

    return wrapped


def hvp(func: Callable, x, v):
    """Hessian-vector product of a scalar function, without forming the
    Hessian."""
    _, hv = AF.hvp(func, x, v)
    return hv.detach()


class Jacobian:
    """The full Jacobian of ``func`` at the tensor ``xs``; index it
    ``[i, j]`` or read ``.values``."""

    _transform = staticmethod(AF.jacobian)

    def __init__(self, func: Callable, xs):
        self._mat = self._transform(func, xs, vectorize=False).detach()

    @property
    def values(self):
        return self._mat

    def __getitem__(self, idx):
        return self._mat[idx]


class Hessian(Jacobian):
    """The full Hessian of a scalar ``func`` at the tensor ``xs``."""

    _transform = staticmethod(AF.hessian)
