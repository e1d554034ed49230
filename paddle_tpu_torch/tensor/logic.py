"""Comparison and logical ops (counterpart of the reference's
``tensor/logic.py``)."""
from __future__ import annotations

import torch

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "equal_all", "logical_and",
           "logical_or", "logical_xor", "logical_not", "isnan", "isinf",
           "isfinite", "isclose", "allclose", "is_empty", "bitwise_and",
           "bitwise_or", "bitwise_xor", "bitwise_not"]


def equal(x, y):
    return torch.eq(x, y)


def not_equal(x, y):
    return torch.ne(x, y)


def greater_than(x, y):
    return torch.gt(x, y)


def greater_equal(x, y):
    return torch.ge(x, y)


def less_than(x, y):
    return torch.lt(x, y)


def less_equal(x, y):
    return torch.le(x, y)


def equal_all(x, y):
    """Whether the shapes and every element agree (a 0-d bool tensor)."""
    same = tuple(x.shape) == tuple(y.shape) and bool(torch.equal(x, y))
    return torch.tensor(same, device=x.device)


def logical_and(x, y):
    return torch.logical_and(x, y)


def logical_or(x, y):
    return torch.logical_or(x, y)


def logical_xor(x, y):
    return torch.logical_xor(x, y)


def logical_not(x):
    return torch.logical_not(x)


def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def isclose(x, y, rtol: float = 1e-5, atol: float = 1e-8,
            equal_nan: bool = False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(x, y, rtol: float = 1e-5, atol: float = 1e-8,
             equal_nan: bool = False):
    """A 0-d bool tensor."""
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


def is_empty(x):
    return x.numel() == 0


def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


def bitwise_not(x):
    return torch.bitwise_not(x)
