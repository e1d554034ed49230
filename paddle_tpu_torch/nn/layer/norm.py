"""Normalization layers (counterpart of the reference's
``nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class LayerNorm(nn.Module):
    """paddle.nn.LayerNorm: weight ones, bias zeros, epsilon 1e-5."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return "normalized_shape=%s, epsilon=%s" % (self._normalized_shape,
                                                    self._epsilon)
