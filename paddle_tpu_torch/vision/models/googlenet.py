"""GoogLeNet / Inception-v1 (counterpart of the reference's
``vision/models/googlenet.py``): every forward, in training and in eval,
returns ``(out, aux1, aux2)``, the auxiliary heads hanging off inception
4a and 4d."""
from __future__ import annotations


from ... import nn
from ...tensor import concat, flatten
from ._utils import weight_kw

__all__ = ["GoogLeNet", "googlenet"]


class _Inception(nn.Layer):
    """Four parallel branches concatenated on channels."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj, kw):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_c, c1, 1, **kw), nn.ReLU())
        self.b3 = nn.Sequential(
            nn.Conv2D(in_c, c3r, 1, **kw), nn.ReLU(),
            nn.Conv2D(c3r, c3, 3, padding=1, **kw), nn.ReLU())
        self.b5 = nn.Sequential(
            nn.Conv2D(in_c, c5r, 1, **kw), nn.ReLU(),
            nn.Conv2D(c5r, c5, 5, padding=2, **kw), nn.ReLU())
        self.bp = nn.Sequential(
            nn.MaxPool2D(3, 1, padding=1),
            nn.Conv2D(in_c, proj, 1, **kw), nn.ReLU())

    def forward(self, x):
        return concat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                      axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_c, num_classes, kw):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = nn.Conv2D(in_c, 128, 1, **kw)
        self.relu = nn.ReLU()
        self.fc1 = nn.Linear(128 * 16, 1024, **kw)
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = self.relu(self.fc1(flatten(x, 1)))
        return self.fc2(self.dropout(x))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, device=None, seed: int = 0):
        super().__init__()
        kw = weight_kw(device, seed)
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
            nn.Conv2D(64, 64, 1, **kw), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
        )
        self.pre = nn.Sequential(
            _Inception(192, 64, 96, 128, 16, 32, 32, kw),     # 3a -> 256
            _Inception(256, 128, 128, 192, 32, 96, 64, kw),   # 3b -> 480
            nn.MaxPool2D(3, 2, padding=1),
            _Inception(480, 192, 96, 208, 16, 48, 64, kw),    # 4a -> 512
        )
        self.mid = nn.Sequential(
            _Inception(512, 160, 112, 224, 24, 64, 64, kw),   # 4b
            _Inception(512, 128, 128, 256, 24, 64, 64, kw),   # 4c
            _Inception(512, 112, 144, 288, 32, 64, 64, kw),   # 4d -> 528
        )
        self.post = nn.Sequential(
            _Inception(528, 256, 160, 320, 32, 128, 128, kw),  # 4e -> 832
            nn.MaxPool2D(3, 2, padding=1),
            _Inception(832, 256, 160, 320, 32, 128, 128, kw),  # 5a
            _Inception(832, 384, 192, 384, 48, 128, 128, kw),  # 5b -> 1024
        )
        self.aux1 = _AuxHead(512, num_classes, kw)
        self.aux2 = _AuxHead(528, num_classes, kw)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.dropout = nn.Dropout(0.4)
        self.fc = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        h4a = self.pre(self.stem(x))
        h4d = self.mid(h4a)
        h = self.pool(self.post(h4d))
        out = self.fc(self.dropout(flatten(h, 1)))
        return out, self.aux1(h4a), self.aux2(h4d)


def googlenet(**kwargs) -> GoogLeNet:
    return GoogLeNet(**kwargs)
