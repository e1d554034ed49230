"""Common functionals (counterpart of the reference's
``nn/functional/common.py``): the Paddle-layout linear, embedding,
dropout, and the composition branch of ``scaled_dot_product_attention``.

No library attention is called here: the attention below is the plain
matmul-softmax-matmul composition, op for op the reference's fallback.
"""
from __future__ import annotations

import math

import torch


def linear(x, weight, bias=None):
    """Paddle weight layout [in_features, out_features]."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight):
    return weight[x.long()]


def dropout(x, p: float = 0.5, training: bool = True):
    """Dropout in Paddle's default ``upscale_in_train`` mode."""
    if not training or p == 0.0:
        return x
    return torch.nn.functional.dropout(x, p, training=True)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 training: bool = True):
    """Batched [B, H, L, D] attention: scores / sqrt(D), an additive mask
    added, softmax, then the value product -- the reference's composition
    route (boolean masks are made additive by the caller)."""
    d = query.shape[-1]
    scores = torch.matmul(query, key.transpose(-1, -2)) / math.sqrt(d)
    if attn_mask is not None:
        scores = scores + attn_mask
    weights = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        weights = dropout(weights, dropout_p, training=training)
    return torch.matmul(weights, value)
