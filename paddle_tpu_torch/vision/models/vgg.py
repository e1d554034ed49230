"""VGG 11/13/16/19 (counterpart of the reference's
``vision/models/vgg.py``), with or without BatchNorm after each conv;
``features.i`` and ``classifier.i`` index as the reference's."""
from __future__ import annotations


from ... import nn
from ...tensor import flatten
from ._utils import refuse_pretrained, weight_kw

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False, device=None, seed: int = 0):
    kw = weight_kw(device, seed)
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=kw["device"]))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """``features`` (``_make_features``) then a 7 x 7 pool and the
    three-layer classifier; the classifier's draws continue ``seed + 1``'s
    generator on the features' device."""

    def __init__(self, features, num_classes: int = 1000,
                 with_pool: bool = True, seed: int = 0):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            dev = next(iter(features.parameters())).device
            kw = weight_kw(dev, seed + 1)
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, seed: int = 0,
         **kwargs):
    refuse_pretrained(pretrained)
    return VGG(_make_features(_CFGS[cfg], batch_norm, device, seed),
               seed=seed, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
