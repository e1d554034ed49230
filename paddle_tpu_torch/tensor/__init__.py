"""``paddle_tpu_torch.tensor``: the tensor-op surface (counterpart of the
reference's ``tensor/`` package): ``attribute``, ``creation``,
``einsum``, ``linalg``, ``logic``, ``manipulation``, ``math``,
``random``, ``search``, ``segment`` (sequence masks, padding and segment
reductions) and ``stat``, with the reference's names and argument
conventions (``axis=``, ``keepdim=``).

Installed as the reference installs its namespace:

- every op takes and ignores a ``name=`` keyword (the reference's
  program-variable name);
- every op is behind the op shim (``framework.dispatch.install_ops``)
  under its own name: under ``amp.auto_cast`` the products the white list
  names (``matmul``, ``bmm``, ``mm``, ``mv``, ``addmm``, ``einsum``) run
  in the amp dtype and the ops the black list names (``exp``, ``log``,
  ``sum``, ``mean``, ``pow``, ``norm``, ``var``, ...) in float32, and
  ``FLAGS_check_nan_inf`` scans each output;
- the in-place variants ``add_``, ``subtract_``, ``ceil_``, ``clip_``,
  ``exp_``, ``flatten_``, ``floor_``, ``reciprocal_``, ``reshape_``,
  ``round_``, ``rsqrt_``, ``scale_``, ``scatter_``, ``sqrt_``,
  ``squeeze_``, ``tanh_``, ``unsqueeze_``: the op's result written into
  its first argument, which is returned.  They are functions here;
  ``torch.Tensor``'s own methods stay torch's.

Ops with no tensor input (``zeros``, ``arange``, ``randn``, ...) take the
device as ``place=`` (``None``: ``cuda``), as ``to_tensor`` does.
``array`` (tensor arrays) and ``control_flow`` (``while_loop``, ``case``,
``switch_case``; ``cond`` stays linalg's condition number here, as in the
reference, and the control-flow ``cond`` is ``static.nn.cond`` or
``tensor.control_flow.cond``) run eagerly as Python and become
``torch.while_loop``/``torch.cond`` under ``torch.export``.  ``tolist``
reads a tensor into nested lists; ``install_methods`` attaches the ops as
``torch.Tensor`` methods where torch has no method of that name (it is
not run at import: torch's own methods are never replaced).
"""
from __future__ import annotations

import functools
import inspect
import types

import torch

from . import (array, attribute, creation, einsum as _einsum_mod, linalg,
               logic, manipulation, math, random, search, segment, stat)
from ._compat import accept_name_kwarg
from .array import *  # noqa: F401,F403
from .attribute import *  # noqa: F401,F403
from .control_flow import case, switch_case, while_loop  # noqa: F401
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .segment import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from ..core.errors import InvalidArgumentError
from ..framework import dispatch as _dispatch

_INPLACE = ("add", "subtract", "ceil", "clip", "exp", "flatten", "floor",
            "reciprocal", "reshape", "round", "rsqrt", "scale", "scatter",
            "sqrt", "squeeze", "tanh", "unsqueeze")

__all__ = list(dict.fromkeys(
    n for mod in (attribute, creation, _einsum_mod, linalg, logic,
                  manipulation, math, random, search, segment, stat)
    for n in mod.__all__)) + [n + "_" for n in _INPLACE]
# the tensor arrays, the control flow and ``tolist`` take containers,
# callables or a read-back rather than tensors to ops: they stay out of
# the op shim and of ``__all__`` (the root imports them by name)
STRUCTURE = list(array.__all__) + ["case", "switch_case", "while_loop",
                                   "tolist"]


def tolist(x):
    """Nested Python lists of ``x``'s values (read back to the host)."""
    return x.tolist()


# first parameters that are not the tensor: creation-style ops (the
# reference's list), an array, the control flow's predicates and callables
_NOT_METHODS = ("data", "shape", "dtype", "equation", "start", "num_rows",
                "low", "array", "pred_fn_pairs", "cond_fn", "branch_index")


def install_methods(cls=torch.Tensor) -> list:
    """Attach every op of this namespace whose first parameter is the
    tensor as a method of ``cls`` (``x.op(...)``, as the reference's
    ``install_methods``), skipping every name ``cls`` already has: torch's
    own methods and operators are never replaced.  Returns the names
    added."""
    ns = globals()
    added = []
    for name in __all__ + STRUCTURE:
        fn = ns.get(name)
        if not isinstance(fn, types.FunctionType) or hasattr(cls, name):
            continue
        try:
            params = list(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            continue
        if not params or params[0] in _NOT_METHODS:
            continue

        def method(self, *args, _f=fn, **kwargs):
            return _f(self, *args, **kwargs)

        method.__name__ = name
        method.__doc__ = fn.__doc__
        setattr(cls, name, method)
        added.append(name)
    return added


def _make_inplace(op, name: str):
    """``op``'s result written into its first argument: an equal shape is
    copied in; a new shape of the same storage (``reshape``, ``flatten``,
    ``squeeze``, ``unsqueeze``) re-strides the tensor in place."""

    @functools.wraps(op)
    def inplace(x, *args, **kwargs):
        out = op(x, *args, **kwargs)
        if tuple(out.shape) == tuple(x.shape):
            return x.copy_(out)
        if out.untyped_storage().data_ptr() != \
                x.untyped_storage().data_ptr():
            raise InvalidArgumentError(
                "%s: the result of shape %s is not a view of the input of "
                "shape %s (a non-contiguous input?)"
                % (name, tuple(out.shape), tuple(x.shape)))
        return x.as_strided_(out.shape, out.stride(), out.storage_offset())

    inplace.__name__ = inplace.__qualname__ = name
    inplace.__paddle_tpu_op__ = True  # its op is behind the shim already
    return inplace


def _install(namespace: dict) -> None:
    for key in __all__:
        val = namespace.get(key)
        if isinstance(val, types.FunctionType):
            namespace[key] = accept_name_kwarg(val)
    _dispatch.install_ops(namespace)
    for base in _INPLACE:
        namespace[base + "_"] = _make_inplace(namespace[base], base + "_")


_install(globals())
