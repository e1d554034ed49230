"""Device namespace (``paddle.device``; counterpart of the reference's
``device.py``).

The place machinery lives in ``paddle_tpu_torch.core.device``; this module
re-exports it with the vendor probes.  The port is a CUDA build:
``is_compiled_with_cuda()`` says whether torch was built with CUDA and
``get_cudnn_version()`` is torch's cuDNN version; the ROCm, XPU, NPU and
TPU probes are false.
"""
from __future__ import annotations

import torch

from .core.device import (  # noqa: F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    NPUPlace,
    Place,
    TPUPlace,
    XPUPlace,
    current_place,
    device_count,
    get_device,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    set_device,
    synchronize,
)

__all__ = [
    "get_cudnn_version",
    "set_device",
    "get_device",
    "current_place",
    "device_count",
    "synchronize",
    "Place",
    "CPUPlace",
    "CUDAPlace",
    "CUDAPinnedPlace",
    "XPUPlace",
    "NPUPlace",
    "TPUPlace",
    "is_compiled_with_xpu",
    "is_compiled_with_cuda",
    "is_compiled_with_rocm",
    "is_compiled_with_npu",
    "is_compiled_with_tpu",
]


def get_cudnn_version():
    """torch's cuDNN version as an int (``None`` in a build without it)."""
    return torch.backends.cudnn.version()


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False
