"""The ``name=`` keyword every public op accepts (counterpart of the
reference's ``tensor/_compat.py``).

The reference threads a cosmetic ``name=`` into its program's variable
naming; the port has no per-op variable to name, so every public op takes
the keyword and ignores it.  ``install_name_kwarg`` applies the shim to a
namespace, so ``paddle_tpu_torch.matmul`` and
``paddle_tpu_torch.tensor.linalg.matmul`` agree.
"""
from __future__ import annotations

import functools
import inspect
import types

__all__ = ["accept_name_kwarg", "install_name_kwarg"]


def accept_name_kwarg(fn):
    """``fn`` taking (and ignoring) a keyword-only ``name=``; ``fn`` itself
    when it already takes ``name`` or ``**kwargs``."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return fn
    params = sig.parameters
    if "name" in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                               for p in params.values()):
        return fn

    @functools.wraps(fn)
    def wrapper(*args, name=None, **kwargs):
        return fn(*args, **kwargs)

    wrapper.__signature__ = sig.replace(parameters=[
        *params.values(),
        inspect.Parameter("name", inspect.Parameter.KEYWORD_ONLY,
                          default=None)])
    wrapper.__paddle_tpu_name_shim__ = True
    return wrapper


def install_name_kwarg(module_globals: dict) -> None:
    """Give every public function of a namespace dict the ``name=``
    keyword."""
    for key, val in list(module_globals.items()):
        if key.startswith("_"):
            continue
        if isinstance(val, types.FunctionType) \
                and not getattr(val, "__paddle_tpu_name_shim__", False):
            module_globals[key] = accept_name_kwarg(val)
