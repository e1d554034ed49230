"""ShuffleNetV2 x0.25-x2.0 (counterpart of the reference's
``vision/models/shufflenetv2.py``): split units and downsampling units,
each ending in a two-group channel shuffle."""
from __future__ import annotations


from ... import nn
from ...core.errors import InvalidArgumentError
from ...tensor import concat, flatten
from ._utils import weight_kw

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


def _channel_shuffle(x, groups: int):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


class _Unit(nn.Layer):
    def __init__(self, in_c, out_c, stride, kw):
        super().__init__()
        dev = kw["device"]
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            main_in = in_c // 2
        else:
            main_in = in_c
            self.short = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=2, padding=1, groups=in_c,
                          bias_attr=False, **kw),
                nn.BatchNorm2D(in_c, device=dev),
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False, **kw),
                nn.BatchNorm2D(branch_c, device=dev), nn.ReLU(),
            )
        self.main = nn.Sequential(
            nn.Conv2D(main_in, branch_c, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(branch_c, device=dev), nn.ReLU(),
            nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                      groups=branch_c, bias_attr=False, **kw),
            nn.BatchNorm2D(branch_c, device=dev),
            nn.Conv2D(branch_c, branch_c, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(branch_c, device=dev), nn.ReLU(),
        )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = concat([x[:, :c], self.main(x[:, c:])], axis=1)
        else:
            out = concat([self.short(x), self.main(x)], axis=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    """``scale`` one of 0.25, 0.5, 1.0, 1.5, 2.0."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 device=None, seed: int = 0):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise InvalidArgumentError(
                "scale must be one of %s" % sorted(_STAGE_OUT))
        kw = weight_kw(device, seed)
        dev = kw["device"]
        c0, c1, c2, c3, c4 = _STAGE_OUT[scale]
        self.stem = nn.Sequential(
            nn.Conv2D(3, c0, 3, stride=2, padding=1, bias_attr=False, **kw),
            nn.BatchNorm2D(c0, device=dev), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1))
        stages = []
        in_c = c0
        for out_c, repeats in ((c1, 4), (c2, 8), (c3, 4)):
            stages.append(_Unit(in_c, out_c, 2, kw))
            for _ in range(repeats - 1):
                stages.append(_Unit(out_c, out_c, 1, kw))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.head = nn.Sequential(
            nn.Conv2D(in_c, c4, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(c4, device=dev), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))
        self.classifier = nn.Linear(c4, num_classes, **kw)

    def forward(self, x):
        x = self.head(self.stages(self.stem(x)))
        return self.classifier(flatten(x, 1))


def shufflenet_v2_x0_25(**kw):
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_5(**kw):
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x1_5(**kw):
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return ShuffleNetV2(2.0, **kw)
