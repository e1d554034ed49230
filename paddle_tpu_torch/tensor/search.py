"""Search and sort (counterpart of the reference's ``tensor/search.py``).
Sorts are stable; ``descending`` reverses the ascending order, as the
reference's.  ``nonzero``, ``masked_select`` and a one-argument
``where`` have data-dependent shapes and read the device back."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue",
           "mode", "where", "nonzero", "masked_select", "index_sample",
           "searchsorted"]


def argmax(x, axis=None, keepdim: bool = False, dtype="int64"):
    return torch.argmax(x, dim=axis, keepdim=keepdim).to(convert_dtype(dtype))


def argmin(x, axis=None, keepdim: bool = False, dtype="int64"):
    return torch.argmin(x, dim=axis, keepdim=keepdim).to(convert_dtype(dtype))


def argsort(x, axis: int = -1, descending: bool = False):
    idx = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(idx, (axis,)) if descending else idx


def sort(x, axis: int = -1, descending: bool = False):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def topk(x, k: int, axis: int = -1, largest: bool = True,
         sorted: bool = True):
    """``(values, indices)`` of the k largest (or smallest) along
    ``axis``, always sorted (as the reference's)."""
    return tuple(torch.topk(x, k, dim=axis, largest=largest, sorted=True))


def kthvalue(x, k: int, axis: int = -1, keepdim: bool = False):
    """The k-th smallest along ``axis`` and its index (stable order)."""
    srt, idx = torch.sort(x, dim=axis, stable=True)
    vals = srt.narrow(axis, k - 1, 1)
    inds = idx.narrow(axis, k - 1, 1)
    if not keepdim:
        vals, inds = vals.squeeze(axis), inds.squeeze(axis)
    return vals, inds


def mode(x, axis: int = -1, keepdim: bool = False):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its last occurrence in ``x``: a stable sort and run
    lengths from cumulative max/min scans, as the reference's."""
    axis = axis % x.ndim
    n = x.shape[axis]
    order = torch.argsort(x, dim=axis, stable=True)
    srt = torch.take_along_dim(x, order, dim=axis)
    view = [1] * x.ndim
    view[axis] = n
    idx = torch.arange(n, device=x.device).reshape(view).expand(srt.shape)
    is_start = (idx == 0) | (srt != torch.roll(srt, 1, axis))
    is_end = (idx == n - 1) | (srt != torch.roll(srt, -1, axis))
    start = torch.cummax(torch.where(is_start, idx, -1), dim=axis).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(is_end, idx, n),
                                             (axis,)), dim=axis).values,
                     (axis,))
    best = torch.argmax(end - start + 1, dim=axis, keepdim=True)
    vals = torch.take_along_dim(srt, best, dim=axis)
    orig = torch.take_along_dim(order, torch.take_along_dim(end, best,
                                                            dim=axis),
                                dim=axis)
    if not keepdim:
        vals, orig = vals.squeeze(axis), orig.squeeze(axis)
    return vals, orig.long()


def where(condition, x=None, y=None):
    """``x`` where ``condition``, else ``y``; with neither, the indices of
    the true entries, as a tuple."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    if x is None or y is None:
        raise InvalidArgumentError(
            "where requires x and y to be both given or both None; got "
            f"x={'None' if x is None else 'set'}, "
            f"y={'None' if y is None else 'set'}")
    return torch.where(condition, x, y)


def nonzero(x, as_tuple: bool = False):
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


def masked_select(x, mask):
    return torch.masked_select(x, mask)


def index_sample(x, index):
    return torch.take_along_dim(x, index.long(), dim=1)


def searchsorted(sorted_sequence, values, out_int32: bool = False,
                 right: bool = False):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)
