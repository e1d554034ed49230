"""Common layers (counterpart of the reference's ``nn/layer/common.py``).

Parameter names and shapes are the reference's -- ``Linear.weight`` is
[in_features, out_features], Paddle's layout, not torch's [out, in] -- so
carrying weights across is a copy (``convert.load_reference_params``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F


def xavier_normal_(t: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """The reference's XavierNormal on a 2-D [fan_in, fan_out] tensor."""
    fan_in, fan_out = t.shape[0], t.shape[1]
    with torch.no_grad():
        return t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                         generator=generator)


class Linear(nn.Module):
    """paddle.nn.Linear: weight [in_features, out_features], bias zeros."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(xavier_normal_(torch.empty(
            in_features, out_features, device=device), generator))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return "in_features=%d, out_features=%d" % (self.in_features,
                                                    self.out_features)


class Embedding(nn.Module):
    """paddle.nn.Embedding: weight [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = nn.Parameter(xavier_normal_(torch.empty(
            num_embeddings, embedding_dim, device=device), generator))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return "%d, %d" % (self._num_embeddings, self._embedding_dim)


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)

    def extra_repr(self):
        return "p=%s" % self.p
