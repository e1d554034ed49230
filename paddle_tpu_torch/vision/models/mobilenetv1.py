"""MobileNetV1 (counterpart of the reference's
``vision/models/mobilenetv1.py``): a stem and 13 depthwise-separable
blocks (``blocks.i.dw``, ``blocks.i.pw``), ``scale`` the width
multiplier."""
from __future__ import annotations


from ... import nn
from ...tensor import flatten
from ._utils import weight_kw

__all__ = ["MobileNetV1", "mobilenet_v1"]


def _round(c: float) -> int:
    return max(1, int(c))


class _DepthwiseSeparable(nn.Layer):
    """3x3 depthwise then 1x1 pointwise, each Conv-BN-ReLU."""

    def __init__(self, in_c, out_c, stride, kw):
        super().__init__()
        dev = kw["device"]
        self.dw = nn.Sequential(
            nn.Conv2D(in_c, in_c, 3, stride=stride, padding=1, groups=in_c,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(in_c, device=dev), nn.ReLU())
        self.pw = nn.Sequential(
            nn.Conv2D(in_c, out_c, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, device=dev), nn.ReLU())

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None, seed: int = 0):
        super().__init__()
        kw = weight_kw(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = scale
        self.stem = nn.Sequential(
            nn.Conv2D(3, _round(32 * s), 3, stride=2, padding=1,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(_round(32 * s), device=kw["device"]), nn.ReLU())
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2), (512, 512, 1), (512, 512, 1),
               (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 1024, 2),
               (1024, 1024, 1)]
        self.blocks = nn.Sequential(*[
            _DepthwiseSeparable(_round(i * s), _round(o * s), st, kw)
            for i, o, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(_round(1024 * s), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(scale: float = 1.0, **kwargs) -> MobileNetV1:
    return MobileNetV1(scale=scale, **kwargs)
