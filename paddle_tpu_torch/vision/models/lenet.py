"""LeNet (counterpart of the reference's ``vision/models/lenet.py``)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core.device import resolve_device
from ...tensor import flatten

__all__ = ["LeNet"]


class LeNet(tnn.Module):
    """LeNet-5 for 1 x 28 x 28 inputs, the reference's layers and
    parameter names (``features.0.weight``, ``fc.2.bias``, ...), built on
    ``device`` (None: ``cuda``) from a generator seeded with ``seed``."""

    def __init__(self, num_classes: int = 10, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, **kw),
                nn.Linear(120, 84, **kw),
                nn.Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x
