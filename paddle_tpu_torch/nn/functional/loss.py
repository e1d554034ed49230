"""Loss functionals (counterpart of the reference's
``nn/functional/loss.py``): ``cross_entropy`` with the fused
softmax-with-cross-entropy semantics, and ``softmax_with_cross_entropy``.

Not ported yet: the other losses of the reference's file.
"""
from __future__ import annotations

import torch

from ...core.errors import InvalidArgumentError

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise InvalidArgumentError(
        "reduction must be mean|sum|none, got %r" % reduction)


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Softmax cross entropy.  ``input``: logits (probabilities when
    ``use_softmax=False``); ``label``: int class ids (a trailing axis of 1
    is squeezed), or distributions when ``soft_label`` or shaped like
    ``input``.  Hard labels equal to ``ignore_index`` add nothing and are
    left out of the mean; ``weight`` [C] weighs each class (the mean then
    divides by the summed weights); ``label_smoothing`` mixes in the
    uniform distribution."""
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, 1e-10, 1.0))
    if soft_label or (label.ndim == input.ndim
                      and tuple(label.shape) == tuple(input.shape)):
        soft = label
        if label_smoothing > 0.0:
            n = input.shape[axis]
            soft = soft * (1.0 - label_smoothing) + label_smoothing / n
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    lbl = label
    if lbl.ndim == input.ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = torch.gather(logp, axis, safe.unsqueeze(axis))
    loss = -picked.squeeze(axis)
    if label_smoothing > 0.0:
        smooth_loss = -logp.mean(dim=axis)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth_loss
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe], 0.0).sum()
        else:
            denom = valid.to(loss.dtype).sum().clamp(min=1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Per-position loss with the class axis kept (size 1); with
    ``return_softmax`` also the softmax of ``logits``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
