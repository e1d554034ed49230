"""Normalization functionals (counterpart of the reference's
``nn/functional/norm.py``)."""
from __future__ import annotations

import torch


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Layer norm over the trailing ``normalized_shape`` axes with the
    biased variance and ``epsilon`` inside the square root, as the
    reference."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
