"""Shape and layout manipulation (counterpart of the reference's
``tensor/manipulation.py``): its names and arguments, on torch's views,
gathers and scatters."""
from __future__ import annotations

import builtins
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = [
    "cast", "reshape", "flatten", "squeeze", "unsqueeze", "concat", "stack",
    "unstack", "unbind", "split", "chunk", "tile", "expand", "expand_as",
    "broadcast_to", "transpose", "flip", "roll", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "scatter_nd", "index_select", "slice", "strided_slice", "unique",
    "reverse", "broadcast_shape", "broadcast_tensors", "crop",
    "shard_index"]


def cast(x, dtype):
    return torch.as_tensor(x).to(convert_dtype(dtype))


def reshape(x, shape: Sequence[int]):
    return torch.reshape(x, tuple(shape))


def flatten(x, start_axis: int = 0, stop_axis: int = -1):
    ndim = x.ndim
    if ndim == 0:
        return x.reshape(1)
    start, stop = start_axis % ndim, stop_axis % ndim
    if start > stop:
        raise InvalidArgumentError(
            f"flatten requires start_axis <= stop_axis, got {start_axis} > "
            f"{stop_axis} for ndim={ndim}")
    return torch.flatten(x, start, stop)


def squeeze(x, axis=None):
    """Drop the size-1 axes of ``axis`` (all of them when None); a listed
    axis of another size stays."""
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = [axis]
    axis = tuple(a % x.ndim for a in axis if x.shape[a % x.ndim] == 1)
    return torch.squeeze(x, axis) if axis else x


def unsqueeze(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    out = x
    for a in sorted(a % (out.ndim + 1) for a in axis):
        out = out.unsqueeze(a)
    return out


def concat(x: Sequence, axis: int = 0):
    return torch.cat(list(x), dim=axis)


def stack(x: Sequence, axis: int = 0):
    return torch.stack(list(x), dim=axis)


def unstack(x, axis: int = 0, num: Optional[int] = None) -> List:
    return list(torch.unbind(x, dim=axis))


unbind = unstack


def split(x, num_or_sections: Union[int, Sequence[int]],
          axis: int = 0) -> List:
    """Into ``num_or_sections`` equal parts, or parts of the listed sizes
    (one ``-1`` takes the rest)."""
    axis = axis % x.ndim
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise InvalidArgumentError(
                f"split: dim {axis} of size {total} does not divide into "
                f"{num_or_sections} equal parts")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sections = list(num_or_sections)
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = total - known
    if builtins.sum(sections) != total:
        raise InvalidArgumentError(
            f"split sections {sections} must sum to dim {axis} size {total}")
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks: int, axis: int = 0) -> List:
    """``chunks`` parts whose sizes differ by at most one, the larger
    first (numpy's ``array_split``)."""
    return list(torch.tensor_split(x, chunks, dim=axis))


def tile(x, repeat_times: Sequence[int]):
    return torch.tile(x, tuple(repeat_times))


def expand(x, shape: Sequence[int]):
    """Broadcast to ``shape``; -1 keeps that axis."""
    return x.expand(*shape)


def expand_as(x, y):
    return x.expand(y.shape)


def broadcast_to(x, shape: Sequence[int]):
    return torch.broadcast_to(x, tuple(shape))


def transpose(x, perm: Sequence[int]):
    return x.permute(*perm)


def flip(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, dims=axis)


def gather(x, index, axis: int = 0):
    """Entries of ``axis`` at ``index``; the index's shape replaces that
    axis."""
    idx = torch.as_tensor(index, device=x.device).long()
    axis = axis % x.ndim
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def gather_nd(x, index):
    """``index[..., k]`` addresses the first k axes of ``x``."""
    index = torch.as_tensor(index, device=x.device).long()
    return x[tuple(index.movedim(-1, 0))]


def take_along_axis(x, indices, axis: int):
    return torch.take_along_dim(x, indices.long(), dim=axis)


def put_along_axis(x, indices, values, axis: int, reduce: str = "assign"):
    """A copy of ``x`` with ``values`` put at ``indices`` along ``axis``
    (``"assign"``, ``"add"``, or ``"mul"``/``"multiply"``)."""
    idx = indices.long()
    values = torch.as_tensor(values, dtype=x.dtype,
                             device=x.device).broadcast_to(idx.shape)
    if reduce == "assign":
        return x.scatter(axis, idx, values)
    if reduce == "add":
        return x.scatter_add(axis, idx, values)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, idx, values, "prod")
    raise ValueError(f"unsupported reduce mode {reduce!r}")


def scatter(x, index, updates, overwrite: bool = True):
    """A copy of ``x`` with rows ``index`` (axis 0) set to ``updates``;
    without ``overwrite`` the rows are zeroed, then every update is added
    (duplicates sum)."""
    idx = torch.as_tensor(index, device=x.device).long().reshape(-1)
    if overwrite:
        return x.index_copy(0, idx, updates)
    return x.index_fill(0, idx, 0).index_add(0, idx, updates)


def scatter_nd_add(x, index, updates):
    index = torch.as_tensor(index, device=x.device).long()
    return x.index_put(tuple(index.movedim(-1, 0)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape):
    zeros = torch.zeros(tuple(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis: int = 0):
    return torch.index_select(x, axis, torch.as_tensor(
        index, device=x.device).long())


def slice(x, axes: Sequence[int], starts: Sequence[int],
          ends: Sequence[int]):
    slices = [builtins.slice(None)] * x.ndim
    for ax, s, e in zip(axes, starts, ends):
        slices[ax] = builtins.slice(s, e)
    return x[tuple(slices)]


def strided_slice(x, axes, starts, ends, strides):
    """``x[start:end:stride]`` on each listed axis; a negative stride
    walks backwards."""
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        rng = range(*builtins.slice(s, e, st).indices(out.shape[ax]))
        out = torch.index_select(out, ax, torch.tensor(
            list(rng), dtype=torch.long, device=x.device))
    return out


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """numpy's ``unique`` (sorted values, then the asked-for first
    indices, inverse ids and counts) by ``torch.unique`` on ``x``'s
    device; the output's shape depends on the data.  A value's first
    index is the least position whose inverse id is that value's."""
    dim = None if axis is None else axis % max(x.ndim, 1)
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    out = [vals]
    if return_index:
        ids = inv.reshape(-1)
        first = torch.full((counts.shape[0],), ids.shape[0],
                           dtype=torch.long, device=x.device)
        out.append(first.scatter_reduce(
            0, ids, torch.arange(ids.shape[0], device=x.device),
            reduce="amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def reverse(x, axis):
    """Flip along the listed axes."""
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, tuple(axes))


def broadcast_shape(x_shape, y_shape):
    """The shape two shapes broadcast to."""
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(input):
    return list(torch.broadcast_tensors(*input))


def crop(x, shape=None, offsets=None):
    """The block of ``shape`` at ``offsets``; a shape entry of -1 runs to
    the end of that axis."""
    ndim = x.ndim
    shape = list(x.shape) if shape is None else shape
    starts = [0] * ndim if offsets is None else [int(o) for o in offsets]
    slices = []
    for i, s in enumerate(shape):
        dim = int(x.shape[i])
        size = dim - starts[i] if int(s) == -1 else int(s)
        if starts[i] < 0 or starts[i] + size > dim:
            raise InvalidArgumentError(
                "crop out of bounds on axis %d: offset %d + size %d > dim %d"
                % (i, starts[i], size, dim))
        slices.append(builtins.slice(starts[i], starts[i] + size))
    return x[tuple(slices)]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids as ids local to shard ``shard_id``; ids of other shards
    become ``ignore_value``."""
    if not 0 <= shard_id < nshards:
        raise InvalidArgumentError(
            "shard_id %d out of range [0, %d)" % (shard_id, nshards))
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, shard_size, rounding_mode="floor") \
        == shard_id
    return torch.where(in_shard, torch.remainder(input, shard_size),
                       ignore_value)
