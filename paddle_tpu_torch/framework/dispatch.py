"""The autocast shim of the port's public ops (counterpart of the autocast
part of the reference's ``framework/dispatch.py``: ``_amp_apply`` and
``install_ops``).

``install_ops(namespace)`` wraps every public function of a namespace
under its own name, and that name is the op name the ``amp`` white and
black lists match.  While ``amp.auto_cast`` is on, a white op gets its
floating tensor arguments (nested in lists, tuples and dicts too) cast to
the amp dtype and a black op gets them cast to float32; every other op
sees its arguments unchanged.  The cast is ``Tensor.to``, which autograd
records, so gradients return in the caller's dtype, as the reference's
vjp transposes its cast.  With autocast off a wrapped op costs one
thread-local read: no device work and no host sync, so it may run inside
a captured CUDA graph.

The reference's Tensor facade, tape, NaN check and profiler hooks have no
counterpart here: ``torch.Tensor`` is the port's Tensor and torch's
autograd records the graph.  Calls inside a functional module reach the
raw functions, as the reference's inner ``jnp`` calls do.
"""
from __future__ import annotations

import functools
import types
from typing import Callable

import torch

from ..core import amp_state

__all__ = ["make_op", "install_ops"]


def _target(st: amp_state.AmpAttrs, op_name: str):
    """The dtype autocast gives ``op_name``'s floating inputs, or None."""
    if op_name in st.white:
        return torch.bfloat16 if st.dtype == "bfloat16" else torch.float16
    if op_name in st.black:
        return torch.float32
    return None


def _cast(v, tgt: torch.dtype):
    """``v`` with every floating tensor in it cast to ``tgt``."""
    if isinstance(v, torch.Tensor):
        return v.to(tgt) if v.is_floating_point() and v.dtype != tgt else v
    if isinstance(v, tuple):
        items = [_cast(x, tgt) for x in v]
        return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
    if isinstance(v, list):
        return [_cast(x, tgt) for x in v]
    if isinstance(v, dict):
        return {k: _cast(x, tgt) for k, x in v.items()}
    return v


def make_op(fn: Callable, op_name: str) -> Callable:
    """``fn`` behind the autocast shim, under the op name ``op_name``."""

    @functools.wraps(fn)
    def op(*args, **kwargs):
        st = amp_state.current()
        if st.enabled:
            tgt = _target(st, op_name)
            if tgt is not None:
                args = _cast(args, tgt)
                kwargs = _cast(kwargs, tgt)
        return fn(*args, **kwargs)

    op.__paddle_tpu_op__ = True
    return op


def install_ops(namespace: dict) -> None:
    """Wrap every public function of a namespace dict with :func:`make_op`
    under its own name."""
    for key, val in list(namespace.items()):
        if key.startswith("_"):
            continue
        if isinstance(val, types.FunctionType) \
                and not getattr(val, "__paddle_tpu_op__", False):
            namespace[key] = make_op(val, key)
