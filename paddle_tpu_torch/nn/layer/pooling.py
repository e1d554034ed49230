"""Pooling layers (counterpart of the reference's
``nn/layer/pooling.py``): the twelve pools over ``nn.functional``'s."""
from __future__ import annotations


from .. import functional as F
from .layers import Layer


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, "NCL")

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            False, self.ceil_mode, self.data_format)


class MaxPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            False, self.ceil_mode, self.data_format)


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            False, self.ceil_mode, self.data_format)


class AvgPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, "NCL")
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode, self.data_format)


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format)
        self.exclusive = exclusive
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class AvgPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format)
        self.exclusive = exclusive
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)
