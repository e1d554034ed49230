"""Ragged and variable-length utilities (counterpart of the reference's
``tensor/segment.py``): dense padded tensors with integer metadata
(lengths, segment ids) in place of LoD tensors.

- ``sequence_mask``, ``lengths_to_segment_ids``: [B] lengths to a
  [B, maxlen] mask or to row ids (-1 on pads);
- ``sequence_pad`` / ``sequence_unpad``: the host boundary (a list of
  ragged rows to one padded tensor and back);
- ``segment_sum/mean/max/min``, ``segment_softmax``: reductions over
  segment ids, ids < 0 dropped (padding); an empty segment reports 0, as
  the reference's;
- ``masked_mean``: the mean over the positions a mask keeps.

``maxlen=None`` and ``num_segments=None`` read the largest length or id
back from the device, as the reference does eagerly.  Inside a CUDA-graph
capture nothing may be read back, so there they must be passed, or the
call raises :class:`InvalidArgumentError`, as the reference's raises under
``jit``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad",
    "lengths_to_segment_ids", "segment_sum", "segment_mean", "segment_max",
    "segment_min", "segment_softmax", "masked_mean",
]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _read_back_max(t: torch.Tensor, what: str) -> int:
    """``max(t)`` on the host (0 for an empty ``t``); refused while the
    current stream captures."""
    if _capturing(t):
        raise InvalidArgumentError(
            "%s must be given inside a CUDA-graph capture (nothing is read "
            "back from the device there)" % what)
    return int(t.max()) if t.numel() else 0


def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="bool"):
    """[B] lengths -> [B, maxlen] validity mask (position < length).
    ``maxlen`` defaults to ``max(lengths)``, read back from the device."""
    lengths = _as_tensor(lengths)
    if maxlen is None:
        maxlen = _read_back_max(lengths, "sequence_mask's maxlen")
    pos = torch.arange(int(maxlen), device=lengths.device)
    mask = pos < lengths[..., None]
    dt = convert_dtype(dtype)
    return mask if dt == torch.bool else mask.to(dt)


def sequence_pad(sequences: Sequence, pad_value=0.0,
                 maxlen: Optional[int] = None):
    """A list of [Li, ...] rows -> ([B, maxlen, ...] padded, [B] int32
    lengths), on the rows' device (the CPU for numpy rows)."""
    if not len(sequences):
        raise InvalidArgumentError("sequence_pad needs at least one sequence")
    rows = [_as_tensor(s) for s in sequences]
    lengths = [int(r.shape[0]) for r in rows]
    cap = int(maxlen) if maxlen is not None else max(lengths)
    if max(lengths) > cap:
        raise InvalidArgumentError(
            "sequence_pad: a sequence of length %d exceeds maxlen=%d"
            % (max(lengths), cap))
    first = rows[0]
    out = torch.full((len(rows), cap) + tuple(first.shape[1:]), pad_value,
                     dtype=first.dtype, device=first.device)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out, torch.tensor(lengths, dtype=torch.int32, device=first.device)


def sequence_unpad(x, length) -> List[torch.Tensor]:
    """[B, L, ...] and [B] lengths -> a list of [Li, ...] rows (the lengths
    are read back: ragged shapes live on the host)."""
    x = _as_tensor(x)
    lens = _as_tensor(length).tolist()
    return [x[i, :int(n)] for i, n in enumerate(lens)]


def lengths_to_segment_ids(lengths, maxlen: Optional[int] = None):
    """[B] lengths -> [B, maxlen] int32 ids: the row where valid, -1 on
    pads."""
    mask = sequence_mask(lengths, maxlen=maxlen)
    rows = torch.arange(mask.shape[0], dtype=torch.int32,
                        device=mask.device)[:, None].expand(mask.shape)
    return torch.where(mask, rows, torch.full_like(rows, -1))


def _num_segments(ids: torch.Tensor, num_segments: Optional[int]) -> int:
    if num_segments is not None:
        return int(num_segments)
    return _read_back_max(ids, "num_segments") + 1 if ids.numel() else 0


def _flat(data, segment_ids):
    """(ids [N] int64, data [N, ...]) with the ids' leading axes merged."""
    ids = _as_tensor(segment_ids)
    data = _as_tensor(data)
    flat_ids = ids.reshape(-1).long()
    return flat_ids, data.reshape((flat_ids.shape[0],)
                                  + tuple(data.shape[ids.ndim:]))


def _lanes(flat_ids, n: int):
    """Each id with the dropped ones (< 0) sent to the extra slot ``n``."""
    return torch.where(flat_ids >= 0, flat_ids, torch.full_like(flat_ids, n))


def segment_sum(data, segment_ids, num_segments: Optional[int] = None):
    """Per-segment sum over the ids' axes; ids < 0 are dropped."""
    n = _num_segments(_as_tensor(segment_ids), num_segments)
    flat_ids, flat = _flat(data, segment_ids)
    out = torch.zeros((n + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    return out.index_add(0, _lanes(flat_ids, n), flat)[:n]


def segment_mean(data, segment_ids, num_segments: Optional[int] = None):
    """Per-segment mean; an empty segment gives 0."""
    ids = _as_tensor(segment_ids)
    n = _num_segments(ids, num_segments)
    total = segment_sum(data, ids, n)
    counts = segment_sum(torch.ones(ids.shape, dtype=total.dtype,
                                    device=total.device), ids, n)
    counts = counts.reshape(tuple(counts.shape)
                            + (1,) * (total.ndim - counts.ndim))
    return total / counts.clamp(min=1)


def _segment_extreme(data, segment_ids, num_segments, largest: bool):
    ids = _as_tensor(segment_ids)
    n = _num_segments(ids, num_segments)
    flat_ids, flat = _flat(data, ids)
    lanes = _lanes(flat_ids, n)
    if flat.dtype.is_floating_point:
        init = -float("inf") if largest else float("inf")
    else:
        info = torch.iinfo(flat.dtype)
        init = info.min if largest else info.max
    out = torch.full((n + 1,) + tuple(flat.shape[1:]), init,
                     dtype=flat.dtype, device=flat.device)
    idx = lanes.reshape((-1,) + (1,) * (flat.ndim - 1)).expand(flat.shape)
    out = out.scatter_reduce(0, idx, flat, "amax" if largest else "amin",
                             include_self=True)[:n]
    # an empty segment reports 0 (found by count: isfinite says nothing
    # about an integer dtype)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=flat.device) \
        .index_add(0, lanes, (flat_ids >= 0).long())[:n]
    counts = counts.reshape((n,) + (1,) * (out.ndim - 1))
    return torch.where(counts > 0, out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))


def segment_max(data, segment_ids, num_segments: Optional[int] = None):
    """Per-segment max; an empty segment gives 0."""
    return _segment_extreme(data, segment_ids, num_segments, True)


def segment_min(data, segment_ids, num_segments: Optional[int] = None):
    """Per-segment min; an empty segment gives 0."""
    return _segment_extreme(data, segment_ids, num_segments, False)


def segment_softmax(data, segment_ids, num_segments: Optional[int] = None):
    """Softmax within each segment, 0 at dropped ids (two segment
    reductions and the exponentials between them)."""
    ids = _as_tensor(segment_ids).long()
    data = _as_tensor(data)
    n = _num_segments(ids, num_segments)
    valid = (ids >= 0).reshape(tuple(ids.shape)
                               + (1,) * (data.ndim - ids.ndim))
    safe = ids.clamp(min=0)
    mx = segment_max(data, ids, n)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))[safe]
    e = torch.where(valid, torch.exp(data - mx), torch.zeros_like(data))
    den = segment_sum(e, ids, n)[safe]
    return torch.where(valid, e / den.clamp(min=1e-30), torch.zeros_like(e))


def masked_mean(x, mask, axis=None):
    """Mean over the positions where ``mask`` is true (a count of 0 counts
    as 1)."""
    x = _as_tensor(x)
    m = _as_tensor(mask).to(device=x.device, dtype=torch.bool) \
        .expand(x.shape)
    kept = torch.where(m, x, torch.zeros_like(x))
    if axis is None:
        return kept.sum() / m.sum().clamp(min=1)
    return kept.sum(dim=axis) / m.sum(dim=axis).clamp(min=1)
