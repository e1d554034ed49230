"""Common functionals (counterpart of the reference's
``nn/functional/common.py``): the Paddle-layout linear, embedding (with
``padding_idx`` and row-sparse gradients), dropout, and
``scaled_dot_product_attention`` with its routing between the flash
kernel K3 and the matmul-softmax-matmul composition.

No library attention is called here: the kernel route goes to the port's
own K3 (``ops.flash_attention``), the other route is the composition, op
for op the reference's fallback.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def linear(x, weight, bias=None):
    """Paddle weight layout [in_features, out_features]."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight, padding_idx: Optional[int] = None,
              sparse: bool = False):
    """Rows of ``weight`` at the ids ``x``; zeros where an id equals
    ``padding_idx`` (whatever that row holds), whose row then gets no
    gradient.  With ``sparse`` the weight's gradient is a sparse COO
    tensor of the rows met (``framework.sparse``), except inside
    ``framework.sparse.dense_gradients()`` (a train step), where it is
    dense.  The forward is the same gather either way."""
    from ...framework.sparse import sparse_gradients_enabled

    ids = x.long()
    if sparse and sparse_gradients_enabled():
        # torch reads a negative padding_idx from the end; the reference
        # compares the ids with it as given, which no id equals
        pad = padding_idx if padding_idx is not None and padding_idx >= 0 \
            else None
        out = torch.nn.functional.embedding(ids, weight, padding_idx=pad,
                                            sparse=True)
    else:
        out = weight[ids]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p: float = 0.5, training: bool = True):
    """Dropout in Paddle's default ``upscale_in_train`` mode."""
    if not training or p == 0.0:
        return x
    return torch.nn.functional.dropout(x, p, training=True)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Batched [B, H, L, D] attention.

    4-D attention without dropout and without a boolean mask goes to
    ``ops.flash_attention.flash_attention``, which alone decides between
    the flash kernel K3 and the composition by the kernel's limits.  On the
    way a materialized 2-D additive causal mask becomes ``causal=True`` and
    a [B, 1, 1, Lk] additive padding mask becomes ``key_padding_mask``, so
    the kernel never reads an [L, L] bias.  Dropout and boolean masks keep
    the composition here (scores / sqrt(D), masks, softmax, dropout, value
    product)."""
    from ...ops.flash_attention import (detect_causal_additive_mask,
                                        detect_padding_additive_mask,
                                        flash_attention)

    d = query.shape[-1]
    drop_p = dropout_p if training else 0.0
    if drop_p == 0.0 and query.ndim == 4 \
            and (attn_mask is None or attn_mask.dtype != torch.bool):
        mask = attn_mask
        causal = is_causal
        if not causal and detect_causal_additive_mask(mask, query.shape[-2]):
            causal, mask = True, None
        key_mask = None
        if mask is not None:
            pad_valid = detect_padding_additive_mask(mask)
            if pad_valid is not None \
                    and pad_valid.shape[-1] == key.shape[-2]:
                key_mask, mask = pad_valid, None
        return flash_attention(query, key, value, bias=mask, causal=causal,
                               key_padding_mask=key_mask)
    scores = torch.matmul(query, key.transpose(-1, -2)) / math.sqrt(d)
    if is_causal:
        q_len, k_len = scores.shape[-2], scores.shape[-1]
        allow = torch.ones(q_len, k_len, dtype=torch.bool,
                           device=scores.device).tril()
        scores = torch.where(allow, scores, torch.finfo(scores.dtype).min)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores,
                                 torch.finfo(scores.dtype).min)
        else:
            scores = scores + attn_mask
    weights = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        weights = dropout(weights, dropout_p, training=training)
    return torch.matmul(weights, value)
