"""The op shim of the port's public ops: autocast and the nan/inf check
(counterpart of those parts of the reference's ``framework/dispatch.py``:
``_amp_apply``, ``_post_op`` and ``install_ops``).

``install_ops(namespace)`` wraps every public function of a namespace
under its own name, and that name is the op name the ``amp`` white and
black lists match.  While ``amp.auto_cast`` is on, a white op gets its
floating tensor arguments (nested in lists, tuples and dicts too) cast to
the amp dtype and a black op gets them cast to float32; every other op
sees its arguments unchanged.  The cast is ``Tensor.to``, which autograd
records, so gradients return in the caller's dtype, as the reference's
vjp transposes its cast.  With autocast and the nan check off a wrapped
op costs one thread-local read and one flag read: no device work and no
host sync, so it may run inside a captured CUDA graph.

Under ``FLAGS_check_nan_inf`` an op's floating outputs (nested in
tuples, lists and dicts) are scanned after it runs, and a nan or an inf
raises :class:`~..core.errors.InvalidArgumentError` naming the op, as the
reference's eager epilogue does.  The scan reads the device back, so it
is skipped while a CUDA graph captures on the current stream, as the
reference skips traced values: a host read would void the capture.  With
the flag off it costs one flag read.

An op called with a ``static.Variable`` among its arguments (at the top
level, in a top-level list or tuple, or as a keyword) is recorded into the
variable's program instead of running (``register_symbolic``, which
``static`` calls on import; the reference's static-graph bridge).  Until
then the check costs one global read.

While ``profiler.start_profiler`` runs, or while ``FLAGS_benchmark`` is
set, an op synchronizes its device after it runs and records its wall
time with ``profiler.record_op_time`` (the reference's ``_maybe_t0`` and
``_post_op``); inside a CUDA-graph capture it records nothing.  With both
off that costs two reads of a flag.

The reference's Tensor facade and tape have no counterpart here:
``torch.Tensor`` is the port's Tensor and torch's autograd records the
graph.  Calls inside a
functional module reach the raw functions, as the reference's inner
``jnp`` calls do.
"""
from __future__ import annotations

import functools
import types
from typing import Callable

import torch

from ..core import amp_state
from ..core.errors import InvalidArgumentError
from ..core.flags import _REGISTRY as _FLAGS

__all__ = ["make_op", "install_ops", "check_nan_inf", "register_symbolic",
           "set_op_timing", "op_timing_on"]


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


def _floating_leaves(v):
    if isinstance(v, torch.Tensor):
        if v.is_floating_point() or v.is_complex():
            yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _floating_leaves(x)
    elif isinstance(v, dict):
        for x in v.values():
            yield from _floating_leaves(x)


def check_nan_inf(out, op_name: str) -> None:
    """Raise naming ``op_name`` when a floating tensor of ``out`` holds a
    nan or an inf; skipped while the current stream captures."""
    leaves = [t.detach() for t in _floating_leaves(out)]
    if not leaves:
        return
    if any(t.is_cuda for t in leaves) \
            and torch.cuda.is_current_stream_capturing():
        return
    finite = torch.stack([torch.isfinite(t).all() for t in leaves]).all()
    if not bool(finite):
        raise InvalidArgumentError(
            "nan/inf detected in output of op %r (FLAGS_check_nan_inf)"
            % op_name)


_NAN_FLAG = _FLAGS["FLAGS_check_nan_inf"]
_BENCH_FLAG = _FLAGS["FLAGS_benchmark"]
# whether the op profiler runs (``profiler.start_profiler``)
_PROFILING = [False]


def set_op_timing(on: bool) -> None:
    """Turn the op profiler's timing on or off (the profiler's switch)."""
    _PROFILING[0] = bool(on)


def op_timing_on() -> bool:
    return _PROFILING[0] or bool(_BENCH_FLAG.value)


def _timed_call(fn, op_name: str, args, kwargs):
    """``fn(*args, **kwargs)``, its device synchronized, its wall time
    recorded under ``op_name``; nothing recorded while a CUDA graph
    captures (no synchronize may run then)."""
    import time

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    cuda = [t for t in _tensor_leaves(out) if t.is_cuda]
    if cuda:
        if torch.cuda.is_current_stream_capturing():
            return out
        torch.cuda.synchronize(cuda[0].device)
    from .. import profiler

    profiler.record_op_time(op_name, time.perf_counter() - t0)
    return out


def _tensor_leaves(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _tensor_leaves(x)
    elif isinstance(v, dict):
        for x in v.values():
            yield from _tensor_leaves(x)


def make_op(fn: Callable, op_name: str) -> Callable:
    """``fn`` behind the autocast shim and the nan/inf check, under the op
    name ``op_name``."""

    @functools.wraps(fn)
    def op(*args, **kwargs):
        if _symbolic_cls is not None and _has_symbolic(args, kwargs):
            return _symbolic_handler(fn, op_name, args, kwargs)
        st = amp_state.current()
        if st.enabled:
            tgt = _target(st, op_name)
            if tgt is not None:
                args = _cast(args, tgt)
                kwargs = _cast(kwargs, tgt)
        if _BENCH_FLAG.value or _PROFILING[0]:
            out = _timed_call(fn, op_name, args, kwargs)
        else:
            out = fn(*args, **kwargs)
        if _NAN_FLAG.value:
            check_nan_inf(out, op_name)
        return out

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


# -- static-graph bridge ----------------------------------------------------
# ``static`` registers its Variable type and a handler: an op called with a
# Variable among its arguments is recorded into the variable's program.
_symbolic_cls = None
_symbolic_handler = None


def _has_symbolic(args, kwargs) -> bool:
    cls = _symbolic_cls
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, cls):
            return True
        if isinstance(a, (list, tuple)) and any(isinstance(x, cls)
                                                for x in a):
            return True
    return False


def register_symbolic(cls, handler) -> None:
    """Record ops on ``cls`` instances through ``handler(fn, op_name, args,
    kwargs)``."""
    global _symbolic_cls, _symbolic_handler
    _symbolic_cls = cls
    _symbolic_handler = handler
