"""Activation functionals (counterpart of the reference's
``nn/functional/activation.py``)."""
from __future__ import annotations

import torch


def relu(x):
    return torch.relu(x)


def gelu(x):
    """Exact (erf) GELU, as the reference's ``jax.nn.gelu(...,
    approximate=False)``."""
    return torch.nn.functional.gelu(x)
