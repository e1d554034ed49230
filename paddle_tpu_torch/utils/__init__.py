"""``paddle_tpu_torch.utils`` (counterpart of the reference's
``utils/__init__.py``): ``deprecated``, ``try_import``, ``run_check``,
``require_version``, ``unique_name``, ``download`` and the C++ extension
path (``cpp_extension``).  ``run_check`` computes on the card (a product,
and a rank-order sum over a logical group), where the reference runs a
product on its default backend and a sum over a CPU mesh."""
from __future__ import annotations

import functools
import importlib
import warnings

from . import cpp_extension  # noqa: F401
from . import download  # noqa: F401
from . import unique_name  # noqa: F401

__all__ = ["deprecated", "run_check", "require_version", "try_import",
           "unique_name", "cpp_extension", "download"]


def deprecated(update_to: str = "", since: str = "", reason: str = "",
               level: int = 0):
    """Warn on use (``level`` 2: raise ``RuntimeError``)."""

    def decorator(fn):
        msg = "API %r is deprecated since %s" % (
            getattr(fn, "__name__", str(fn)), since or "this release")
        if update_to:
            msg += ", use %r instead" % update_to
        if reason:
            msg += " (%s)" % reason

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if level == 2:
                raise RuntimeError(msg)
            if level >= 0:
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def try_import(module_name: str, err_msg: str = ""):
    """The module, or an ``ImportError`` naming it."""
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(
            err_msg or "%s is required but not installed; this no-egress "
            "build cannot fetch it" % module_name)


def require_version(min_version: str, max_version: str = None) -> bool:
    """Raise ``RuntimeError`` unless this package's version lies in
    ``[min_version, max_version]``."""
    from ..version import full_version

    def parse(v):
        return tuple(int(x) for x in str(v).split(".")[:3] if x.isdigit())

    cur = parse(full_version)
    if parse(min_version) > cur:
        raise RuntimeError(
            "installed version %s is below required %s"
            % (full_version, min_version))
    if max_version is not None and parse(max_version) < cur:
        raise RuntimeError(
            "installed version %s is above supported %s"
            % (full_version, max_version))
    return True


def run_check(device=None) -> dict:
    """Check that the install computes on ``device`` (the card unless it
    says ``"cpu"``): a 2 x 2 product of ones, and the rank-order sum of 8
    ranks' ones over a logical group on that device (the reference's 8-way
    mesh).  Prints the reference's lines and returns what it checked."""
    import torch

    from ..core.device import resolve_device
    from ..distributed import collective

    dev = resolve_device(device)
    nranks = 8
    a = torch.ones((2, 2), dtype=torch.float32, device=dev)
    total = float(torch.matmul(a, a).sum())
    if total != 8.0:
        raise RuntimeError("run_check: the product of ones summed to %r, "
                           "not 8" % total)
    group = collective.Group(list(range(nranks)), dev, "check")
    summed = collective.all_reduce(
        torch.ones((nranks, 2), dtype=torch.float32, device=dev),
        group=group)
    if not bool((summed == nranks).all()):
        raise RuntimeError("run_check: the rank-order sum over %d ranks is "
                           "wrong" % nranks)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("PaddlePaddle-TPU works well on 1 %s device." % name)
    print("PaddlePaddle-TPU works well on %d ranks of a logical group."
          % nranks)
    print("PaddlePaddle-TPU is installed successfully!")
    return {"device": str(dev), "name": name, "product_sum": total,
            "nranks": nranks}
