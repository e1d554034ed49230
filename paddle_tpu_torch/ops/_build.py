"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` -- no PyTorch headers,
so a build takes seconds, not minutes.  Libraries land in the package's
``_build/`` directory (git-ignored), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

from ..core.errors import ExternalError, UnavailableError

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of every entry point, by source.  Pointers and the stream
# are c_void_p: an undeclared pointer would be passed as a 32-bit int.
SIGNATURES = {
    "decode_attention": {
        "ptt_paged_decode_attention": [
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P,
            _I, _I, _I, _I, _I, _I, _F, _P],
        "ptt_dense_decode_attention": [
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P,
            _I, _I, _I, _I, _I, _F, _P],
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise UnavailableError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels are built at first use")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                   digest.hexdigest()[:16]))


def _compile(name: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ExternalError("nvcc failed for %s.cu (exit %d):\n%s%s"
                            % (name, proc.returncode, proc.stdout,
                               proc.stderr))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not os.path.isfile(p)]
    if not todo:
        return
    errors = []

    def work(n, p):
        try:
            _compile(n, p)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=t) for t in todo]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib
