"""InceptionV3 (counterpart of the reference's
``vision/models/inceptionv3.py``): the 299 x 299 stem and blocks A-E,
one logits output (no auxiliary head)."""
from __future__ import annotations


from ... import nn
from ...tensor import concat, flatten
from ._utils import weight_kw

__all__ = ["InceptionV3", "inception_v3"]


class _ConvBN(nn.Sequential):
    def __init__(self, in_c, out_c, kernel, kw, stride=1, padding=0):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, device=kw["device"]), nn.ReLU())


def _cat(xs):
    return concat(xs, axis=1)


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c, kw):
        super().__init__()
        self.b1 = _ConvBN(in_c, 64, 1, kw)
        self.b5 = nn.Sequential(_ConvBN(in_c, 48, 1, kw),
                                _ConvBN(48, 64, 5, kw, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_c, 64, 1, kw),
                                _ConvBN(64, 96, 3, kw, padding=1),
                                _ConvBN(96, 96, 3, kw, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_c, pool_c, 1, kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)])


class _InceptionB(nn.Layer):  # grid reduction 35 -> 17
    def __init__(self, in_c, kw):
        super().__init__()
        self.b3 = _ConvBN(in_c, 384, 3, kw, stride=2)
        self.b3d = nn.Sequential(_ConvBN(in_c, 64, 1, kw),
                                 _ConvBN(64, 96, 3, kw, padding=1),
                                 _ConvBN(96, 96, 3, kw, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return _cat([self.b3(x), self.b3d(x), self.pool(x)])


class _InceptionC(nn.Layer):  # factorized 7x7
    def __init__(self, in_c, c7, kw):
        super().__init__()
        self.b1 = _ConvBN(in_c, 192, 1, kw)
        self.b7 = nn.Sequential(
            _ConvBN(in_c, c7, 1, kw),
            _ConvBN(c7, c7, (1, 7), kw, padding=(0, 3)),
            _ConvBN(c7, 192, (7, 1), kw, padding=(3, 0)))
        self.b7d = nn.Sequential(
            _ConvBN(in_c, c7, 1, kw),
            _ConvBN(c7, c7, (7, 1), kw, padding=(3, 0)),
            _ConvBN(c7, c7, (1, 7), kw, padding=(0, 3)),
            _ConvBN(c7, c7, (7, 1), kw, padding=(3, 0)),
            _ConvBN(c7, 192, (1, 7), kw, padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_c, 192, 1, kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)])


class _InceptionD(nn.Layer):  # grid reduction 17 -> 8
    def __init__(self, in_c, kw):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(in_c, 192, 1, kw),
                                _ConvBN(192, 320, 3, kw, stride=2))
        self.b7 = nn.Sequential(
            _ConvBN(in_c, 192, 1, kw),
            _ConvBN(192, 192, (1, 7), kw, padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), kw, padding=(3, 0)),
            _ConvBN(192, 192, 3, kw, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class _InceptionE(nn.Layer):  # expanded filter bank
    def __init__(self, in_c, kw):
        super().__init__()
        self.b1 = _ConvBN(in_c, 320, 1, kw)
        self.b3_stem = _ConvBN(in_c, 384, 1, kw)
        self.b3_a = _ConvBN(384, 384, (1, 3), kw, padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), kw, padding=(1, 0))
        self.b3d_stem = nn.Sequential(_ConvBN(in_c, 448, 1, kw),
                                      _ConvBN(448, 384, 3, kw, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), kw, padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), kw, padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_c, 192, 1, kw))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return _cat([self.b1(x), _cat([self.b3_a(s), self.b3_b(s)]),
                     _cat([self.b3d_a(d), self.b3d_b(d)]), self.bp(x)])


class InceptionV3(nn.Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True,
                 device=None, seed: int = 0):
        super().__init__()
        kw = weight_kw(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, kw, stride=2), _ConvBN(32, 32, 3, kw),
            _ConvBN(32, 64, 3, kw, padding=1), nn.MaxPool2D(3, 2),
            _ConvBN(64, 80, 1, kw), _ConvBN(80, 192, 3, kw),
            nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32, kw), _InceptionA(256, 64, kw),
            _InceptionA(288, 64, kw), _InceptionB(288, kw),
            _InceptionC(768, 128, kw), _InceptionC(768, 160, kw),
            _InceptionC(768, 160, kw), _InceptionC(768, 192, kw),
            _InceptionD(768, kw), _InceptionE(1280, kw),
            _InceptionE(2048, kw))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(**kwargs) -> InceptionV3:
    return InceptionV3(**kwargs)
