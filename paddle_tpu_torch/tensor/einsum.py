"""Einsum (counterpart of the reference's ``tensor/einsum.py``); a
product the autocast lists name."""
from __future__ import annotations

import torch

__all__ = ["einsum"]


def einsum(equation: str, *operands):
    return torch.einsum(equation, *operands)
