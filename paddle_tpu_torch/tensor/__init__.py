"""``paddle_tpu_torch.tensor``: the tensor-op surface (counterpart of the
reference's ``tensor/`` package): ``attribute``, ``creation``,
``einsum``, ``linalg``, ``logic``, ``manipulation``, ``math``,
``random``, ``search`` and ``stat``, with the reference's names and
argument conventions (``axis=``, ``keepdim=``).

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
Not ported yet: ``array``, ``control_flow`` and ``segment``.
"""
from __future__ import annotations

import functools
import inspect
import types

from . import (attribute, creation, einsum as _einsum_mod, linalg,
               logic, manipulation, math, random, search, stat)
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from ..core.errors import InvalidArgumentError
from ..framework import dispatch as _dispatch

_INPLACE = ("add", "subtract", "ceil", "clip", "exp", "flatten", "floor",
            "reciprocal", "reshape", "round", "rsqrt", "scale", "scatter",
            "sqrt", "squeeze", "tanh", "unsqueeze")

__all__ = list(dict.fromkeys(
    n for mod in (attribute, creation, _einsum_mod, linalg, logic,
                  manipulation, math, random, search, stat)
    for n in mod.__all__)) + [n + "_" for n in _INPLACE]


def _accept_name(fn):
    """``fn`` taking (and ignoring) a keyword-only ``name=``."""
    params = inspect.signature(fn).parameters
    if "name" in params:
        return fn

    @functools.wraps(fn)
    def op(*args, name=None, **kwargs):
        return fn(*args, **kwargs)

    return op


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
            namespace[key] = _accept_name(val)
    _dispatch.install_ops(namespace)
    for base in _INPLACE:
        namespace[base + "_"] = _make_inplace(namespace[base], base + "_")


_install(globals())
