"""Normalization functionals (counterpart of the reference's
``nn/functional/norm.py``)."""
from __future__ import annotations

import torch


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Layer norm over the trailing ``normalized_shape`` axes with the
    biased variance and ``epsilon`` inside the square root, rounded where
    the reference's ``jnp.mean``/``jnp.var`` round: for a 16-bit ``x``
    both statistics are computed in float32 (the variance about the
    float32 mean) and returned in ``x``'s dtype, and the normalizer is
    ``1 / sqrt`` in that dtype; float32 takes ``rsqrt`` (one launch,
    within an ulp of it).  A bf16 ``x`` times float32 weights comes out
    float32, as in JAX."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    half = x.dtype in (torch.float16, torch.bfloat16)
    xf = x.float() if half else x
    mean32 = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean32).square().mean(dim=axes, keepdim=True).to(x.dtype)
    mean = mean32.to(x.dtype)
    norm = (torch.reciprocal(torch.sqrt(var + epsilon)) if half
            else torch.rsqrt(var + epsilon))
    out = (x - mean) * norm
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
