"""Tensor creation (counterpart of the reference's ``tensor/creation.py``).

The reference's creation ops make arrays on its default device.  The
port's make tensors on ``place`` (a keyword of every op that has no
tensor input to take its device from, as ``to_tensor``'s): ``None`` is
``cuda`` and raises on a machine without a card, so a CPU caller passes
``place="cpu"``.  Float results default to float32 and integer ranges to
int64 (the reference's int64 is int32 while JAX runs without x64).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "eye", "meshgrid", "diag", "diagflat", "tril", "triu", "assign",
           "clone", "numel"]


def _dt(dtype) -> torch.dtype:
    return torch.float32 if dtype is None else convert_dtype(dtype)


def _opt_dt(dtype):
    return None if dtype is None else convert_dtype(dtype)


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


def zeros(shape: Sequence[int], dtype=None, *,
          place: DeviceLike = None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=_dt(dtype),
                       device=resolve_device(place))


def ones(shape: Sequence[int], dtype=None, *,
         place: DeviceLike = None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=_dt(dtype),
                      device=resolve_device(place))


def full(shape: Sequence[int], fill_value, dtype=None, *,
         place: DeviceLike = None) -> torch.Tensor:
    return torch.full(tuple(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device(place))


def empty(shape: Sequence[int], dtype=None, *,
          place: DeviceLike = None) -> torch.Tensor:
    """Zeros, as the reference's (its backend has no uninitialized
    allocation): the contents are defined."""
    return zeros(shape, dtype, place=place)


def zeros_like(x, dtype=None) -> torch.Tensor:
    return torch.zeros_like(x, dtype=_opt_dt(dtype))


def ones_like(x, dtype=None) -> torch.Tensor:
    return torch.ones_like(x, dtype=_opt_dt(dtype))


def full_like(x, fill_value, dtype=None) -> torch.Tensor:
    return torch.full_like(x, fill_value, dtype=_opt_dt(dtype))


def empty_like(x, dtype=None) -> torch.Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, *,
           place: DeviceLike = None) -> torch.Tensor:
    """int64 when every bound is an integer, else float32."""
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer))
                   for v in (start, end, step))
        dtype = torch.int64 if ints else torch.float32
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=resolve_device(place))


def linspace(start, stop, num, dtype=None, *,
             place: DeviceLike = None) -> torch.Tensor:
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=resolve_device(place))


def eye(num_rows: int, num_columns: Optional[int] = None, dtype=None, *,
        place: DeviceLike = None) -> torch.Tensor:
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(num_rows, cols, dtype=_dt(dtype),
                     device=resolve_device(place))


def meshgrid(*args) -> List[torch.Tensor]:
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


def diag(x, offset: int = 0, padding_value: float = 0) -> torch.Tensor:
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix (the rest
    ``padding_value``), or a 2-D ``x``'s diagonal."""
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + abs(offset)
        out = torch.full((n, n), padding_value, dtype=x.dtype,
                         device=x.device)
        idx = torch.arange(x.shape[0], device=x.device)
        r = idx if offset >= 0 else idx - offset
        c = idx + offset if offset >= 0 else idx
        out[r, c] = x
        return out
    return torch.diag(x, offset)


def diagflat(x, offset: int = 0) -> torch.Tensor:
    return torch.diagflat(x, offset)


def tril(x, diagonal: int = 0) -> torch.Tensor:
    return torch.tril(x, diagonal)


def triu(x, diagonal: int = 0) -> torch.Tensor:
    return torch.triu(x, diagonal)


def assign(x, output=None, *, place: DeviceLike = None) -> torch.Tensor:
    """paddle.assign, functional as the reference's: a copy of ``x`` (in
    ``output``'s dtype when given; ``output`` itself is not written)."""
    if not torch.is_tensor(x):
        x = to_tensor(x, place=place)
    if output is None:
        return x.clone()
    return x.to(output.dtype, copy=True)


def clone(x) -> torch.Tensor:
    return x.clone()


def numel(x) -> int:
    return int(x.numel())
