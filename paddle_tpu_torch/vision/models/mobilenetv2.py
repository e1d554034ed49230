"""MobileNetV2 (counterpart of the reference's
``vision/models/mobilenetv2.py``): Sandler et al. 2018's inverted
residuals, ``scale`` the width multiplier.  Parameter and buffer names
are the reference's (``features.1.conv.0.0.weight``,
``features.1.conv.1._mean``, ``classifier.1.weight``)."""
from __future__ import annotations


from ... import nn
from ...tensor import flatten
from ._utils import refuse_pretrained, weight_kw

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, kw=None):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride,
                      padding=(kernel - 1) // 2, groups=groups,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, device=kw["device"]),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio, kw):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1, kw=kw))
        layers.extend([
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, kw=kw),
            nn.Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(oup, device=kw["device"]),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """``scale`` x the published widths; ``num_classes`` 0 drops the
    classifier, ``with_pool=False`` the pool."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None, seed: int = 0):
        super().__init__()
        kw = weight_kw(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = _make_divisible(32 * scale)
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, kw=kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, kw))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel=1, kw=kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2),
                nn.Linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale: float = 1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
