"""AlexNet (counterpart of the reference's
``vision/models/alexnet.py``) for 3 x 224 x 224 inputs."""
from __future__ import annotations


from ... import nn
from ...tensor import flatten
from ._utils import refuse_pretrained, weight_kw

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.5,
                 device=None, seed: int = 0):
        super().__init__()
        kw = weight_kw(device, seed)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096, **kw),
                nn.ReLU(), nn.Dropout(dropout),
                nn.Linear(4096, 4096, **kw), nn.ReLU(),
                nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained: bool = False, **kwargs) -> AlexNet:
    refuse_pretrained(pretrained)
    return AlexNet(**kwargs)
