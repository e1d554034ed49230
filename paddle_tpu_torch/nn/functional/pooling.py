"""Pooling functionals (counterpart of the reference's
``nn/functional/pooling.py``).

The reference lowers every pool to ``lax.reduce_window`` over an
explicitly padded window grid; torch's ``ceil_mode`` and
``count_include_pad`` are other rules, so the port keeps the reference's:

- ``ceil_mode`` pads the high edge of each spatial dim until the windows
  tile it (a window may then lie wholly in padding: -inf for a max pool);
- max pools pad with -inf, average pools sum over zero padding;
- ``exclusive`` average pools divide by the count of real elements in the
  window whenever any padding (``ceil_mode``'s included) is present, and
  by the window's size otherwise or for ``"SAME"``/``"VALID"``;
  ``divisor_override`` divides the sum by that number;
- adaptive pools take bins ``[floor(i * in / out), ceil((i + 1) * in /
  out))`` (``_adaptive_bins``), which are torch's bins too.

Without padding the pool is torch's own (cuDNN/ATen on the card); padded
windows are an explicit ``F.pad`` and a pool at padding 0, except a max
pool whose symmetric padding torch takes itself (no ``ceil_mode``, at most
half the window: ResNet's stem pool).  ``return_mask`` is accepted and
ignored, as in the reference.  Channels-last formats permute to a
channels-first view and back, as ``conv`` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from .conv import (_channels_back, _channels_first, _flat_pads,
                   _normalize_padding, _normalize_tuple, _string_pads)

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _pads(x, k, s, padding, n, ceil_mode):
    """The reference's window padding of the channels-first ``x``: ``n``
    ``(lo, hi)`` pairs (``ceil_mode``'s extra on the high side), and
    whether they came from a string."""
    p = _normalize_padding(padding, n)
    if isinstance(p, str):
        return _string_pads(p, x.shape[2:], k, s), True
    pads = list(p)
    if ceil_mode:
        for i in range(n):
            size = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (size - k[i]) % s[i]
            extra = (s[i] - rem) % s[i] if size >= k[i] else 0
            pads[i] = (pads[i][0], pads[i][1] + extra)
    return pads, False


def _window(kernel_size, stride, n):
    k = _normalize_tuple(kernel_size, n, "kernel_size")
    s = _normalize_tuple(stride if stride is not None else kernel_size, n,
                         "stride")
    return k, s


def _max_pool(x, kernel_size, stride, padding, n, ceil_mode, data_format):
    x, last = _channels_first(x, n, data_format)
    k, s = _window(kernel_size, stride, n)
    pads, _ = _pads(x, k, s, padding, n, ceil_mode)
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        out = _MAX[n](x, k, s, tuple(lo for lo, _ in pads))
    else:
        out = _MAX[n](tF.pad(x, _flat_pads(pads), value=float("-inf")), k,
                      s)
    return _channels_back(out, n, last)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL"):
    return _max_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    return _max_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    return _max_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     data_format)


def _window_sum(x, k, s, n):
    """Sums over the windows of the channels-first ``x`` (no padding)."""
    if n == 1:
        return tF.avg_pool2d(x.unsqueeze(-2), (1,) + k, (1,) + s,
                             divisor_override=1).squeeze(-2)
    return _AVG[n](x, k, s, divisor_override=1)


def _avg_pool(x, kernel_size, stride, padding, n, ceil_mode, exclusive,
              divisor_override, data_format):
    x, last = _channels_first(x, n, data_format)
    k, s = _window(kernel_size, stride, n)
    pads, named = _pads(x, k, s, padding, n, ceil_mode)
    padded = any(p != (0, 0) for p in pads)
    flat = _flat_pads(pads)
    summed = _window_sum(tF.pad(x, flat) if padded else x, k, s, n)
    if divisor_override is not None:
        out = summed / float(divisor_override)
    elif exclusive and padded and not named:
        # the real elements of each window: one map for every row/channel
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = summed / _window_sum(tF.pad(ones, flat), k, s, n)
    else:
        out = summed / float(np.prod(k))
    return _channels_back(out, n, last)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _avg_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     exclusive, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    # the reference's 3-D pool leaves divisor_override out
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, None, data_format)


def _adaptive_bins(in_size: int, out_size: int):
    starts = [(i * in_size) // out_size for i in range(out_size)]
    ends = [-(-((i + 1) * in_size) // out_size) for i in range(out_size)]
    return starts, ends


_ADAPTIVE = {("avg", 1): tF.adaptive_avg_pool1d,
             ("avg", 2): tF.adaptive_avg_pool2d,
             ("avg", 3): tF.adaptive_avg_pool3d,
             ("max", 1): tF.adaptive_max_pool1d,
             ("max", 2): tF.adaptive_max_pool2d,
             ("max", 3): tF.adaptive_max_pool3d}


def _adaptive_pool_nd(x, output_size, n, mode, data_format):
    x, last = _channels_first(x, n, data_format)
    out = _ADAPTIVE[(mode, n)](
        x, _normalize_tuple(output_size, n, "output_size"))
    return _channels_back(out, n, last)


def adaptive_avg_pool1d(x, output_size, data_format="NCL"):
    return _adaptive_pool_nd(x, output_size, 1, "avg", data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool_nd(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool_nd(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive_pool_nd(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive_pool_nd(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive_pool_nd(x, output_size, 3, "max", "NCDHW")
