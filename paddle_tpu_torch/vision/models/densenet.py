"""DenseNet 121/161/169/201/264 (counterpart of the reference's
``vision/models/densenet.py``); ``block_config``/``growth_rate`` override
the chosen config."""
from __future__ import annotations


from ... import nn
from ...core.errors import InvalidArgumentError
from ...tensor import concat, flatten
from ._utils import weight_kw

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    """BN-ReLU-1x1(bn_size * k)-BN-ReLU-3x3(k), concatenated onto its
    input."""

    def __init__(self, in_c, growth, bn_size, kw):
        super().__init__()
        mid = bn_size * growth
        dev = kw["device"]
        self.norm1 = nn.BatchNorm2D(in_c, device=dev)
        self.conv1 = nn.Conv2D(in_c, mid, 1, bias_attr=False, **kw)
        self.norm2 = nn.BatchNorm2D(mid, device=dev)
        self.conv2 = nn.Conv2D(mid, growth, 3, padding=1, bias_attr=False,
                               **kw)
        self.relu = nn.ReLU()

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        return concat([x, out], axis=1)


class _Transition(nn.Sequential):
    def __init__(self, in_c, out_c, kw):
        super().__init__(
            nn.BatchNorm2D(in_c, device=kw["device"]), nn.ReLU(),
            nn.Conv2D(in_c, out_c, 1, bias_attr=False, **kw),
            nn.AvgPool2D(2, 2))


class DenseNet(nn.Layer):
    def __init__(self, layers: int = 121, num_classes: int = 1000,
                 bn_size: int = 4, block_config=None, growth_rate=None,
                 device=None, seed: int = 0):
        super().__init__()
        if layers not in _CFG:
            raise InvalidArgumentError(
                "DenseNet layers must be one of %s" % sorted(_CFG))
        kw = weight_kw(device, seed)
        dev = kw["device"]
        init_c, growth, blocks = _CFG[layers]
        if block_config is not None:
            blocks = tuple(block_config)
        if growth_rate is not None:
            growth = int(growth_rate)
            init_c = 2 * growth
        self.stem = nn.Sequential(
            nn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False,
                      **kw),
            nn.BatchNorm2D(init_c, device=dev), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1))
        feats = []
        c = init_c
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, kw))
                c += growth
            if i + 1 < len(blocks):
                feats.append(_Transition(c, c // 2, kw))
                c //= 2
        self.features = nn.Sequential(*feats)
        self.norm = nn.BatchNorm2D(c, device=dev)
        self.relu = nn.ReLU()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Linear(c, num_classes, **kw)

    def forward(self, x):
        x = self.pool(self.relu(self.norm(self.features(self.stem(x)))))
        return self.classifier(flatten(x, 1))


def densenet121(**kw):
    return DenseNet(121, **kw)


def densenet161(**kw):
    return DenseNet(161, **kw)


def densenet169(**kw):
    return DenseNet(169, **kw)


def densenet201(**kw):
    return DenseNet(201, **kw)


def densenet264(**kw):
    return DenseNet(264, **kw)
