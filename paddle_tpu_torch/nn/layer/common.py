"""Common layers (counterpart of the reference's ``nn/layer/common.py``).

Parameter names and shapes are the reference's -- ``Linear.weight`` is
[in_features, out_features], Paddle's layout, not torch's [out, in] -- so
carrying weights across is a copy (``convert.load_reference_params``).
A Linear with an attached LoRA bank (``nn.lora.attach_lora``) adds the
per-row adapter delta while adapter ids are ambient (``nn.lora``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F
from .. import lora as _lora


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
        out = F.linear(x, self.weight, self.bias)
        lora_a = self._parameters.get("lora_a")
        if lora_a is not None:
            ids = _lora.current_adapter_ids()
            if ids is not None:
                out = _lora.apply_delta(out, x, lora_a, self.lora_b, ids)
        return out

    def extra_repr(self):
        return "in_features=%d, out_features=%d" % (self.in_features,
                                                    self.out_features)


class Embedding(nn.Module):
    """paddle.nn.Embedding: weight [num_embeddings, embedding_dim].

    ``padding_idx``: the output is zeros at that id whatever its row
    holds, and the row gets no gradient.  ``sparse``: the weight's
    gradient is row-sparse (``framework.sparse``), which the optimizers
    update row by row where they can; the forward is the same."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = bool(sparse)
        self.weight = nn.Parameter(xavier_normal_(torch.empty(
            num_embeddings, embedding_dim, device=device), generator))

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

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
