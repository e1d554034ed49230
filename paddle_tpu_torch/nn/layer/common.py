"""Common layers (counterpart of the reference's ``nn/layer/common.py``).

Parameter names and shapes are the reference's -- ``Linear.weight`` is
[in_features, out_features], Paddle's layout, not torch's [out, in] -- so
carrying weights across is a copy (``convert.load_reference_params``).
``weight_attr``/``bias_attr`` are the reference's (``layers.ParamAttr``,
an initializer, a name, or ``False`` for none); the default draws come
from ``generator`` on ``device``.  A Linear with an attached LoRA bank
(``nn.lora.attach_lora``) adds the per-row adapter delta while adapter
ids are ambient (``nn.lora``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from .. import initializer as I
from .. import lora as _lora
from .layers import create_parameter


class Linear(nn.Module):
    """paddle.nn.Linear: weight [in_features, out_features] (XavierNormal),
    bias zeros."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter([in_features, out_features],
                                       weight_attr,
                                       default_initializer=I.XavierNormal(),
                                       **kw)
        self.bias = create_parameter([out_features], bias_attr,
                                     is_bias=True, **kw)

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
    update row by row where they can; the forward is the same.  A
    regularizer given in ``weight_attr`` makes that update dense, as in
    the reference."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = bool(sparse)
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=I.XavierNormal(), device=device,
            generator=generator)

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
