"""Build-integration paths (``paddle.sysconfig``; counterpart of the
reference's ``sysconfig.py``).

``get_include`` serves the C API header (``paddle_tpu_torch_c.h``);
``get_lib`` the directory that holds ``libpaddle_tpu_torch_c.so`` once
``paddle_tpu_torch.capi.build()`` has compiled it.
"""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]

_PKG = os.path.dirname(os.path.abspath(__file__))


def get_include() -> str:
    """Directory containing the port's C header (``paddle_tpu_torch_c.h``)."""
    return os.path.join(_PKG, "include")


def get_lib() -> str:
    """Directory containing ``libpaddle_tpu_torch_c.so`` (call
    ``paddle_tpu_torch.capi.build()`` first to compile it)."""
    from .capi import so_path

    return os.path.dirname(so_path())
