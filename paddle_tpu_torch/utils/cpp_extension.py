"""C++ host ops compiled at run time (counterpart of the reference's
``utils/cpp_extension.py``).

What a C++ extension buys beside the device kernels is *host* compute:
tokenizers, feature hashing, decoders.  ``load`` compiles the sources with
``g++`` into a shared library named by a hash of the sources and flags
(``dlopen`` caches by path, so an edited source gets a new file), and
registers each exported function through ``incubate.register_custom_op``,
with an optional backward written in torch ops.

The ops compute on the host, by the reference's own design (it calls them
through ``jax.pure_callback``): the port copies the inputs to contiguous
float32 host buffers, calls the function through ``ctypes`` and returns
the result on the device of the first input.  This is the op's semantics,
not a fallback from the card.

C ABI (``extension_header()``, the counterpart of ``paddle/extension.h``),
unchanged from the reference::

    extern "C" void <name>(const float** ins, const long long** shapes,
                           const int* ndims, int n_ins, float* out);

The caller gives each function's output shape rule (``out_shape``), as
the reference's InferShapeFn.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["load", "extension_header", "CppExtension", "get_build_directory"]

_HEADER = """\
// paddle_tpu extension header (paddle/extension.h analog, host-op C ABI)
#pragma once
#include <cstdint>
#define PT_OP(name) \\
  extern "C" __attribute__((visibility("default"))) void name( \\
      const float** ins, const long long** shapes, const int* ndims, \\
      int n_ins, float* out)
"""


def extension_header() -> str:
    """The C++ header user sources ``#include "pt_extension.h"`` (``load``
    writes it into the build directory)."""
    return _HEADER


def get_build_directory() -> str:
    """``$PADDLE_EXTENSION_DIR``, else a directory under the system's
    temporary directory; created if missing."""
    d = os.environ.get("PADDLE_EXTENSION_DIR",
                       os.path.join(tempfile.gettempdir(),
                                    "paddle_tpu_torch_extensions"))
    os.makedirs(d, exist_ok=True)
    return d


class CppExtension:
    """A setup()-style bundle of sources."""

    def __init__(self, sources: Sequence[str], name: Optional[str] = None,
                 extra_compile_args=None, **kwargs):
        self.sources = list(sources)
        self.name = name
        self.extra_compile_args = extra_compile_args or []


def _compile(name: str, sources: Sequence[str], extra_flags: Sequence[str],
             build_dir: str, verbose: bool) -> str:
    digest = hashlib.sha1()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(extra_flags).encode())
    so_path = os.path.join(build_dir,
                           "lib%s_%s.so" % (name, digest.hexdigest()[:12]))
    with open(os.path.join(build_dir, "pt_extension.h"), "w") as f:
        f.write(_HEADER)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           "-I", build_dir, *extra_flags, *sources, "-o", so_path]
    if verbose:
        print("cpp_extension:", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise InvalidArgumentError(
            "C++ extension %r failed to compile:\n%s" % (name, proc.stderr))
    return so_path


def _host_op(lib, fn_name: str, out_shape: Callable) -> Callable:
    cfn = getattr(lib, fn_name)
    cfn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p]
    cfn.restype = None

    def forward(*tensors):
        host = [t.detach().to("cpu", torch.float32).contiguous()
                for t in tensors]
        n = len(host)
        ins = (ctypes.c_void_p * n)(*[t.data_ptr() for t in host])
        shapes_store = [(ctypes.c_longlong * max(t.ndim, 1))(
            *(tuple(t.shape) or (1,))) for t in host]
        shapes = (ctypes.c_void_p * n)(
            *[ctypes.addressof(s) for s in shapes_store])
        ndims = (ctypes.c_int * n)(*[t.ndim for t in host])
        out = torch.zeros(tuple(out_shape(*[tuple(t.shape) for t in host])),
                          dtype=torch.float32)
        cfn(ins, shapes, ndims, n, out.data_ptr())
        return out.to(tensors[0].device)

    return forward


def load(name: str, sources: Sequence[str], functions: Dict[str, dict],
         extra_cxx_cflags: Optional[Sequence[str]] = None,
         build_directory: Optional[str] = None, verbose: bool = False):
    """Compile ``sources`` and return a module-like object with each
    function of ``functions`` as a registered op.

    ``functions``: ``{op_name: {"out_shape": fn(*in_shapes) -> shape,
    "backward": optional vjp (residuals, cotangent) -> grads}}``.  Loading
    the same name again registers the new library's functions under
    versioned internal names (``name.fn#v1``, ...), since registry names
    are unique."""
    from ..incubate.custom_op import register_custom_op, registered_custom_ops

    if not functions:
        raise InvalidArgumentError("load needs a functions={...} mapping")
    build_dir = build_directory or get_build_directory()
    so_path = _compile(name, sources, list(extra_cxx_cflags or ()),
                       build_dir, verbose)
    lib = ctypes.CDLL(so_path)

    class _Module:
        __name__ = name
        _library_path = so_path

    mod = _Module()
    taken = registered_custom_ops()
    for fn_name, spec in functions.items():
        if "out_shape" not in spec:
            raise InvalidArgumentError(
                "function %r needs an out_shape rule (the InferShapeFn)"
                % fn_name)
        base = key = "%s.%s" % (name, fn_name)
        version = 0
        while key in taken:
            version += 1
            key = "%s#v%d" % (base, version)
        op = register_custom_op(key, _host_op(lib, fn_name,
                                              spec["out_shape"]),
                                backward=spec.get("backward"))
        setattr(mod, fn_name, op)
    return mod
