"""SqueezeNet 1.0 and 1.1 (counterpart of the reference's
``vision/models/squeezenet.py``)."""
from __future__ import annotations


from ... import nn
from ...core.errors import InvalidArgumentError
from ...tensor import concat, flatten
from ._utils import weight_kw

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.Layer):
    """A 1x1 squeeze, then 1x1 and 3x3 expands concatenated."""

    def __init__(self, in_c, squeeze_c, e1_c, e3_c, kw):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze_c, 1, **kw)
        self.expand1 = nn.Conv2D(squeeze_c, e1_c, 1, **kw)
        self.expand3 = nn.Conv2D(squeeze_c, e3_c, 3, padding=1, **kw)
        self.relu = nn.ReLU()

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(s)),
                       self.relu(self.expand3(s))], axis=1)


class SqueezeNet(nn.Layer):
    """``version`` "1.0" or "1.1"."""

    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 device=None, seed: int = 0):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise InvalidArgumentError("version must be '1.0' or '1.1'")
        kw = weight_kw(device, seed)
        self.num_classes = num_classes
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64, kw), _Fire(128, 16, 64, 64, kw),
                _Fire(128, 32, 128, 128, kw),
                nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128, kw), _Fire(256, 48, 192, 192, kw),
                _Fire(384, 48, 192, 192, kw), _Fire(384, 64, 256, 256, kw),
                nn.MaxPool2D(3, 2),
                _Fire(512, 64, 256, 256, kw),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64, kw), _Fire(128, 16, 64, 64, kw),
                nn.MaxPool2D(3, 2),
                _Fire(128, 32, 128, 128, kw), _Fire(256, 32, 128, 128, kw),
                nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192, kw), _Fire(384, 48, 192, 192, kw),
                _Fire(384, 64, 256, 256, kw), _Fire(512, 64, 256, 256, kw),
            )
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1, **kw),
            nn.ReLU(), nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        return flatten(self.classifier(self.features(x)), 1)


def squeezenet1_0(**kwargs) -> SqueezeNet:
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs) -> SqueezeNet:
    return SqueezeNet("1.1", **kwargs)
