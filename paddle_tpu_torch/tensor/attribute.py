"""Tensor attribute queries (counterpart of the reference's
``tensor/attribute.py``)."""
from __future__ import annotations

import torch

__all__ = ["shape", "rank", "is_tensor", "is_floating_point", "is_integer",
           "is_complex", "real", "imag"]


def shape(x):
    """The shape as an int64 tensor on ``x``'s device."""
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


def rank(x):
    return torch.tensor(x.ndim, dtype=torch.int64, device=x.device)


def is_tensor(x) -> bool:
    return torch.is_tensor(x)


def is_floating_point(x) -> bool:
    return x.is_floating_point()


def is_integer(x) -> bool:
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_complex(x) -> bool:
    return x.is_complex()


def real(x):
    return torch.real(x)


def imag(x):
    """The imaginary part; zeros for a real tensor."""
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)
