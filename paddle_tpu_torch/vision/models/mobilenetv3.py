"""MobileNetV3 Small and Large (counterpart of the reference's
``vision/models/mobilenetv3.py``): Howard et al. 2019's blocks with
squeeze-excite and hardswish, ``scale`` the width multiplier."""
from __future__ import annotations


from ... import nn
from ...tensor import flatten
from ._utils import weight_kw
from .mobilenetv2 import _make_divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]


class _SqueezeExcite(nn.Layer):
    def __init__(self, c, kw, reduction=4):
        super().__init__()
        mid = _make_divisible(c // reduction)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(c, mid, 1, **kw)
        self.fc2 = nn.Conv2D(mid, c, 1, **kw)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))


class _InvertedResidualV3(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, kernel, stride, use_se, act, kw):
        super().__init__()
        dev = kw["device"]
        self.use_res = stride == 1 and in_c == out_c
        act_layer = nn.Hardswish if act == "hswish" else nn.ReLU
        layers = []
        if exp_c != in_c:
            layers += [nn.Conv2D(in_c, exp_c, 1, bias_attr=False, **kw),
                       nn.BatchNorm2D(exp_c, device=dev), act_layer()]
        layers += [nn.Conv2D(exp_c, exp_c, kernel, stride=stride,
                             padding=kernel // 2, groups=exp_c,
                             bias_attr=False, **kw),
                   nn.BatchNorm2D(exp_c, device=dev), act_layer()]
        if use_se:
            layers.append(_SqueezeExcite(exp_c, kw))
        layers += [nn.Conv2D(exp_c, out_c, 1, bias_attr=False, **kw),
                   nn.BatchNorm2D(out_c, device=dev)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, expansion, out, squeeze-excite, activation, stride)
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1), (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1), (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2), (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, hidden, num_classes=1000, scale=1.0,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        kw = weight_kw(device, seed)
        dev = kw["device"]
        self.num_classes = num_classes
        self.with_pool = with_pool

        def sc(c):
            return _make_divisible(c * scale)

        self.stem = nn.Sequential(
            nn.Conv2D(3, sc(16), 3, stride=2, padding=1, bias_attr=False,
                      **kw),
            nn.BatchNorm2D(sc(16), device=dev), nn.Hardswish())
        blocks = []
        in_c = sc(16)
        for k, exp, out, se, act, s in cfg:
            blocks.append(_InvertedResidualV3(in_c, sc(exp), sc(out), k, s,
                                              se, act, kw))
            in_c = sc(out)
        self.blocks = nn.Sequential(*blocks)
        self.head_conv = nn.Sequential(
            nn.Conv2D(in_c, sc(last_exp), 1, bias_attr=False, **kw),
            nn.BatchNorm2D(sc(last_exp), device=dev), nn.Hardswish())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(sc(last_exp), hidden, **kw), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(hidden, num_classes, **kw))

    def forward(self, x):
        x = self.head_conv(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None, seed: int = 0):
        super().__init__(_SMALL, 576, 1024, num_classes, scale, with_pool,
                         device, seed)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None, seed: int = 0):
        super().__init__(_LARGE, 960, 1280, num_classes, scale, with_pool,
                         device, seed)


def mobilenet_v3_small(scale: float = 1.0, **kw) -> MobileNetV3Small:
    return MobileNetV3Small(scale=scale, **kw)


def mobilenet_v3_large(scale: float = 1.0, **kw) -> MobileNetV3Large:
    return MobileNetV3Large(scale=scale, **kw)
