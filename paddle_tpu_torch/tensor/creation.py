"""Tensor creation (counterpart of the reference's ``tensor/creation.py``):
``to_tensor`` only, so far."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = ["to_tensor"]


def to_tensor(data: Any, dtype=None, place: DeviceLike = None,
              stop_gradient: bool = True) -> torch.Tensor:
    """paddle.to_tensor: a new tensor holding a copy of ``data`` (a python
    scalar or list, a numpy array or a tensor).

    A float64 python or numpy input becomes float32 unless ``dtype`` says
    otherwise, as in the reference.  ``place`` is the device; ``None`` is
    ``cuda`` and raises on a machine without a card (pass ``place="cpu"``).
    ``stop_gradient=False`` gives a leaf that requires grad."""
    dev = resolve_device(place)
    dtype = None if dtype is None else convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=dtype, copy=True)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)  # paddle's default float is fp32
        t = torch.tensor(arr, dtype=dtype, device=dev)
    if not stop_gradient:
        if not (t.is_floating_point() or t.is_complex()):
            raise InvalidArgumentError(
                "stop_gradient=False needs a floating point tensor, got %s"
                % (t.dtype,))
        t.requires_grad_(True)
    return t
