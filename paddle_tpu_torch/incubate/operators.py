"""Incubate fused operators (counterpart of the reference's
``incubate/operators.py``): masked softmaxes in plain torch.

The reference writes them as plain jnp that XLA fuses, not as Pallas
kernels, so the port owes no kernel here.  Results come back in the
input's dtype.
"""
from __future__ import annotations

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def softmax_mask_fuse_upper_triangle(x: torch.Tensor) -> torch.Tensor:
    """Causal-masked softmax over the last axis of ``[B, H, Lq, Lk]``
    attention scores, the GPT pattern, with no mask tensor.  Query row i
    sees keys up to ``i + (Lk - Lq)``, so ``Lk >= Lq`` (a KV-cache offset)
    is allowed; the masked keys get probability 0."""
    if x.ndim != 4:
        raise InvalidArgumentError(
            "softmax_mask_fuse_upper_triangle expects [B, H, Lq, Lk], "
            "got rank %d" % x.ndim)
    lq, lk = x.shape[-2], x.shape[-1]
    if lq > lk:
        raise InvalidArgumentError(
            "softmax_mask_fuse_upper_triangle needs Lk >= Lq (got Lq=%d, "
            "Lk=%d): rows past the key length would attend to nothing"
            % (lq, lk))
    keep = torch.ones(lq, lk, dtype=torch.bool, device=x.device).tril(
        diagonal=lk - lq)
    return torch.softmax(x.masked_fill(~keep, float("-inf")),
                         dim=-1).to(x.dtype)


def softmax_mask_fuse(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over ``x + mask`` (an additive attention mask) on the last
    axis."""
    return torch.softmax(x + mask, dim=-1).to(x.dtype)
