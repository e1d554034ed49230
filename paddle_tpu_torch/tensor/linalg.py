"""Linear algebra ops (counterpart of the reference's
``tensor/linalg.py``): ``matmul`` only, so far."""
from __future__ import annotations

import torch

__all__ = ["matmul"]


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    """matmul_v2: ``x @ y`` with either operand's last two axes swapped
    first when asked."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
