"""Convolution layers (counterpart of the reference's
``nn/layer/conv.py``).

The weight is ``[out, in / groups, *k]`` (OI[D]HW) in both data formats,
``[in, out / groups, *k]`` for the transposed layers, drawn from
``Normal(0, sqrt(2 / fan_in))`` with ``fan_in = in / groups * prod(k)``;
the bias is zeros.  ``weight_attr``/``bias_attr`` are the reference's
(``False``: no bias); ``device``/``generator`` as ``Linear``'s."""
from __future__ import annotations

import numpy as np

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from ..functional.conv import _normalize_tuple
from .layers import Layer, create_parameter


class _ConvNd(Layer):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 n: int, stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW",
                 transpose: bool = False, output_padding=0, device=None,
                 generator=None):
        super().__init__()
        if in_channels % groups != 0:
            raise InvalidArgumentError(
                "in_channels %d not divisible by groups %d"
                % (in_channels, groups))
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _normalize_tuple(kernel_size, n, "kernel_size")
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        self._n = n
        if transpose:
            shape = [in_channels, out_channels // groups] \
                + list(self._kernel_size)
        else:
            shape = [out_channels, in_channels // groups] \
                + list(self._kernel_size)
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter(
            shape, weight_attr,
            default_initializer=I.Normal(0.0, (2.0 / fan_in) ** 0.5), **kw)
        self.bias = create_parameter([out_channels], bias_attr,
                                     is_bias=True, **kw)

    def extra_repr(self):
        return "%d, %d, kernel_size=%s, stride=%s, padding=%s" % (
            self._in_channels, self._out_channels, self._kernel_size,
            self._stride, self._padding)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _ConvTransposeNd(_ConvNd):
    _n = 2
    _default_format = "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr,
                         data_format or self._default_format,
                         transpose=True, output_padding=output_padding,
                         device=device, generator=generator)

    def forward(self, x):
        fn = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
              3: F.conv3d_transpose}[self._n]
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._output_padding, self._groups, self._dilation,
                  self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _n = 1
    _default_format = "NCL"


class Conv2DTranspose(_ConvTransposeNd):
    _n = 2
    _default_format = "NCHW"


class Conv3DTranspose(_ConvTransposeNd):
    _n = 3
    _default_format = "NCDHW"
