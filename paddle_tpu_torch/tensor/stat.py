"""Statistics (counterpart of the reference's ``tensor/stat.py``):
median and quantiles interpolate linearly, as numpy's (an even count's
median is the mean of the middle two)."""
from __future__ import annotations

import torch

__all__ = ["median", "nanmedian", "quantile"]


def _quantile(x, q, axis, keepdim, fn):
    """``fn`` (``torch.quantile`` or ``nanquantile``) over ``axis`` (one
    or several axes, every axis when None), the reduced axes moved last
    and flattened."""
    dims = tuple(range(x.ndim)) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    dims = tuple(d % x.ndim for d in dims)
    keep = [d for d in range(x.ndim) if d not in dims]
    flat = x.permute(*keep, *dims).reshape(
        *[x.shape[d] for d in keep], -1)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = fn(flat, qt, dim=-1)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(x.ndim)]
        out = out.reshape(*qt.shape, *shape)
    return out


def median(x, axis=None, keepdim: bool = False):
    return _quantile(x, 0.5, axis, keepdim, torch.quantile)


def nanmedian(x, axis=None, keepdim: bool = False):
    return _quantile(x, 0.5, axis, keepdim, torch.nanquantile)


def quantile(x, q, axis=None, keepdim: bool = False):
    return _quantile(x, q, axis, keepdim, torch.quantile)
