"""Convolution functionals (counterpart of the reference's
``nn/functional/conv.py``).

The reference lowers every convolution to ``lax.conv_general_dilated``;
here each is ``torch.nn.functional.conv{1,2,3}d`` or
``conv_transpose{1,2,3}d`` (cuDNN on the card), with the reference's
padding forms and checks around it:

- ``padding``: an int, one int per spatial dim, one ``(lo, hi)`` pair per
  dim, a flat ``2n`` list ``[lo0, hi0, lo1, hi1, ...]``, or
  ``"SAME"``/``"VALID"`` (XLA's rules: SAME gives ``ceil(in / stride)``
  outputs, the odd pad on the high side).  Symmetric pads go to torch's
  ``padding=``; asymmetric ones are an explicit zero ``F.pad`` first.
- ``data_format`` ``"NLC"``/``"NHWC"``/``"NDHWC"``: the logical
  channels-last tensor is permuted to a channels-first *view* (no copy:
  its strides are torch's ``channels_last``), convolved, and permuted
  back, so cuDNN picks its NHWC kernels.  The weight is OI[D]HW in both
  formats, as the reference's.
- transposed convs: the weight is ``[in, out, *k]``; ``output_padding``
  must be below the stride or the dilation and needs integer padding;
  ``"SAME"``/``"VALID"`` at a stride above 1 and ``groups > 1`` are
  refused, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.errors import InvalidArgumentError

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}
_CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")


def _normalize_tuple(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    if len(v) != n:
        raise InvalidArgumentError("%s must have %d elements, got %r"
                                   % (name, n, v))
    return v


def _normalize_padding(padding, n):
    """paddle padding: int, pair-list, 'SAME'/'VALID', or per-dim pair
    list; a string comes back upper-cased, the rest as ``n`` pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == n and all(isinstance(p, (list, tuple))
                                 for p in padding):
        return [tuple(p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    raise InvalidArgumentError("unsupported padding %r" % (padding,))


def _string_pads(kind, sizes, window, strides):
    """XLA's ``padtype_to_pads``: VALID pads nothing; SAME pads to
    ``ceil(size / stride)`` outputs, the extra element on the high side.
    ``window`` is the effective (dilated) window."""
    if kind == "VALID":
        return [(0, 0)] * len(sizes)
    if kind != "SAME":
        raise InvalidArgumentError("unsupported padding %r" % (kind,))
    pads = []
    for size, k, s in zip(sizes, window, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _channels_first(x, n, data_format):
    """``x`` as a channels-first view, and whether it was channels-last."""
    if data_format in _CHANNEL_LAST:
        return x.permute(0, n + 1, *range(1, n + 1)), True
    return x, False


def _channels_back(y, n, last):
    return y.permute(0, *range(2, n + 2), 1) if last else y


def _flat_pads(pairs):
    """``(lo, hi)`` pairs, first spatial dim first, as ``F.pad``'s list
    (last dim first)."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    x, last = _channels_first(x, n, data_format)
    strides = _normalize_tuple(stride, n, "stride")
    dil = _normalize_tuple(dilation, n, "dilation")
    pads = _normalize_padding(padding, n)
    if isinstance(pads, str):
        window = [d * (k - 1) + 1 for d, k in zip(dil, weight.shape[2:])]
        pads = _string_pads(pads, x.shape[2:], window, strides)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x = tF.pad(x, _flat_pads(pads))
        sym = 0
    out = _CONV[n](x, weight, bias, strides, sym, dil, groups)
    return _channels_back(out, n, last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    fmt = "NLC" if data_format == "NLC" else "NCL"
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    fmt)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, data_format):
    """The reference's transposed conv is an lhs-dilated conv with the
    kernel flipped, padded ``(dil * (k - 1) - lo, dil * (k - 1) - hi +
    output_padding)``: torch's ``conv_transpose`` at padding 0 (its full
    output, ``output_padding`` more on the high side) with ``lo`` cropped
    from the low side and ``hi`` from the high one."""
    if groups != 1:
        raise InvalidArgumentError(
            "conv_transpose with groups>1 is not supported yet")
    x, last = _channels_first(x, n, data_format)
    strides = _normalize_tuple(stride, n, "stride")
    dil = _normalize_tuple(dilation, n, "dilation")
    pads = _normalize_padding(padding, n)
    op = _normalize_tuple(output_padding, n, "output_padding") \
        if output_padding else (0,) * n
    for i in range(n):
        if op[i] >= strides[i] and op[i] >= dil[i]:
            raise InvalidArgumentError(
                "output_padding must be smaller than either stride or "
                "dilation, got output_padding=%s stride=%s dilation=%s"
                % (op, strides, dil))
    if isinstance(pads, str):
        if any(op):
            raise InvalidArgumentError(
                "output_padding requires explicit integer padding, not %r"
                % pads)
        if any(s != 1 for s in strides):
            # as the reference: lax refuses a string with lhs dilation
            raise InvalidArgumentError(
                "a transposed convolution of stride > 1 takes explicit "
                "integer padding, not %r" % pads)
        # the string's pads of the reference's stride-1 conv over the
        # full window: crop what the full output has beyond them
        window = [d * (k - 1) + 1 for d, k in zip(dil, weight.shape[2:])]
        crops = [(k - 1 - lo, k - 1 - hi) for k, (lo, hi) in zip(
            window, _string_pads(pads, x.shape[2:], window, (1,) * n))]
    else:
        crops = pads
    if all(lo == hi for lo, hi in crops):
        return _channels_back(_CONV_T[n](
            x, weight, bias, strides, tuple(lo for lo, _ in crops), op, 1,
            dil), n, last)
    out = _CONV_T[n](x, weight, bias, strides, 0, op, 1, dil)
    index = [slice(None), slice(None)] + [
        slice(lo, out.shape[2 + i] - hi) for i, (lo, hi) in enumerate(crops)]
    return _channels_back(out[tuple(index)], n, last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format)
