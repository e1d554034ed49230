"""The C inference API's build (counterpart of ``paddle_tpu.capi``; the
source is ``paddle_tpu_torch_c.cpp``).

``build()`` compiles ``libpaddle_tpu_torch_c.so`` with the system ``g++``
into the package's ``_build/`` directory at first use and returns its
path.  A C host declares ``PD_Init``, ``PD_GetVersion``,
``PD_PredictorCreate`` (on the card), ``PD_PredictorCreateOnDevice``
(``"cpu"``, ``"cuda"`` or ``"cuda:<id>"``), ``PD_PredictorRunFloat``,
``PD_PredictorDestroy`` and ``PD_Finalize``, and links with
:func:`host_link_args`; ``PD_Init``'s argument puts the package's
checkout and the interpreter's site-packages on the embedded
``sys.path`` (:func:`embed_sys_paths`).
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
import threading

__all__ = ["build", "so_path", "host_link_args", "embed_sys_paths"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "paddle_tpu_torch_c.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "_build",
                   "libpaddle_tpu_torch_c.so")
_build_lock = threading.Lock()


def so_path() -> str:
    return _SO


def _python_link() -> list:
    return ["-L" + sysconfig.get_config_var("LIBDIR"),
            "-lpython" + sysconfig.get_config_var("LDVERSION")]


def build(force: bool = False) -> str:
    """Compile the C API shared library unless it is newer than its
    source.  Builders in one process serialize on a lock, and the compiler
    writes a temporary file that ``os.replace`` promotes, so another
    process never loads a half-written library."""
    with _build_lock:
        if not force and os.path.exists(_SO) \
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return _SO
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        tmp = _SO + ".%d.tmp" % os.getpid()
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC,
               "-I" + sysconfig.get_path("include")] + _python_link() \
            + ["-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, _SO)
    return _SO


def host_link_args() -> list:
    """What a C host's link line adds: the library, its run path and the
    interpreter's library."""
    so = build()
    return [so, "-Wl,-rpath," + os.path.dirname(so),
            "-Wl,-rpath," + sysconfig.get_config_var("LIBDIR")] \
        + _python_link()


def embed_sys_paths() -> str:
    """``PD_Init``'s argument: the checkout holding this package, then this
    interpreter's site-packages, joined by ``:``."""
    checkout = os.path.dirname(os.path.dirname(_HERE))
    site = [p for p in sys.path if p.endswith("site-packages")]
    return ":".join([checkout] + site)
