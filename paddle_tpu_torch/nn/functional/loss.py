"""Loss functionals (counterpart of the reference's
``nn/functional/loss.py``): its twenty functions with its argument names,
defaults and reductions.  ``cross_entropy`` has the fused
softmax-with-cross-entropy semantics; ``ctc_loss`` runs torch's CTC
(``torch.nn.functional.ctc_loss``, the reference's alpha recursion),
normalised as the reference's; the others are torch compositions of the
reference's formulas.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.errors import InvalidArgumentError

__all__ = ["log_loss", "cross_entropy", "softmax_with_cross_entropy",
           "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss", "bce_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_similarity", "sigmoid_focal_loss", "square_error_cost",
           "ctc_loss", "dice_loss", "npair_loss", "hsigmoid_loss"]


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise InvalidArgumentError(
        "reduction must be mean|sum|none, got %r" % reduction)


def log_loss(input, label, epsilon: float = 1e-4):
    """Elementwise negative log likelihood of probabilities ``input``."""
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


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


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """``input``: log-probabilities [N, C, ...]; ``label`` [N, ...] class
    ids.  The mean divides by the weights of the labels counted."""
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    w = None
    if weight is not None:
        w = weight[safe]
        loss = loss * w
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        denom = (w * valid if w is not None else valid.to(loss.dtype)).sum()
        return loss.sum() / denom.clamp(min=1e-12)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction: str = "mean",
                   delta: float = 1.0):
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def bce_loss(input, label, weight=None, reduction: str = "mean"):
    """Binary cross entropy of probabilities ``input``."""
    eps = 1e-12
    loss = -(label * torch.log(input + eps)
             + (1 - label) * torch.log(1 - input + eps))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction: str = "mean"):
    return bce_loss(input, label, weight, reduction)


def binary_cross_entropy_with_logits(input, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None):
    if pos_weight is None:
        # numerically stable: max(x, 0) - x z + log(1 + exp(-|x|))
        loss = torch.clamp(input, min=0) - input * label \
            + torch.log1p(torch.exp(-torch.abs(input)))
    else:
        loss = -(pos_weight * label * tF.logsigmoid(input)
                 + (1 - label) * tF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction: str = "mean"):
    """``input``: log-probabilities; ``label``: probabilities.
    ``"batchmean"`` divides the sum by the batch size."""
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean"):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean"):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt(torch.square(x1).sum(dim=axis))
    n2 = torch.sqrt(torch.square(x2).sum(dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum"):
    p = torch.sigmoid(logit)
    ce = binary_cross_entropy_with_logits(logit, label, reduction="none")
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank: int = 0,
             reduction: str = "mean", norm_by_times: bool = False):
    """CTC loss.  ``log_probs``: [T, N, C] unnormalised logits (the
    softmax is taken here, warpctc's semantics); ``labels`` [N, L]
    padded; the lengths [N].  ``norm_by_times`` divides each sample's
    loss by its input length; ``"mean"`` is warpctc's: each sample's loss
    over its label length, then the mean."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    dev = lp.device
    in_lens = torch.as_tensor(input_lengths, device=dev).long()
    lab_lens = torch.as_tensor(label_lengths, device=dev).long()
    loss = tF.ctc_loss(lp, torch.as_tensor(labels, device=dev).long(),
                       in_lens, lab_lens, blank=blank, reduction="none")
    if norm_by_times:
        loss = loss / torch.clamp(in_lens.float(), min=1.0)
    if reduction == "mean":
        return (loss / torch.clamp(lab_lens.float(), min=1.0)).mean()
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon: float = 1e-5):
    """1 - 2 |X n Y| / (|X| + |Y|) over one-hot labels, the mean over the
    batch."""
    num_classes = input.shape[-1]
    if label.shape[-1] == 1:
        label = label[..., 0]
    one_hot = tF.one_hot(label.long(), num_classes).to(input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = 2.0 * (input * one_hot).sum(dim=dims)
    union = input.sum(dim=dims) + one_hot.sum(dim=dims)
    return (1.0 - (inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    """Softmax cross entropy over anchor . positive^T with same-label
    targets (a column-weighted mean, as the reference's), plus L2 on the
    embeddings."""
    labels = labels.reshape(-1)
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    targets = same / torch.clamp(same.sum(dim=1, keepdim=True), min=1e-9)
    sim = anchor @ positive.T
    ce = -(targets * torch.log_softmax(sim, dim=1)).sum(dim=1)  # [N]
    celoss = (targets * ce[:, None]).sum(dim=0).mean()
    l2 = (torch.square(anchor).sum(dim=1).mean()
          + torch.square(positive).sum(dim=1).mean()) * 0.25 * l2_reg
    return celoss + l2


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse: bool = False):
    """Hierarchical sigmoid: complete-binary-tree paths by default (the
    reference's SimpleCode), custom trees through per-sample
    ``path_table`` / ``path_code``.  ``input`` [N, D]; ``label`` [N] (or
    [N, 1]); ``weight`` [num_classes - 1, D] (or [num_nodes, D]); returns
    [N, 1] losses."""
    label = label.reshape(-1).long()
    if path_table is not None:
        table = torch.as_tensor(path_table, device=input.device).long()
        pc = torch.as_tensor(path_code, device=input.device).float()
        valid = (table >= 0).float()
        idx = table.clamp(min=0)
    else:
        # SimpleCode: c = label + num_classes; node = (c >> (bit + 1)) - 1;
        # branch bit = (c >> bit) & 1; path length = floor(log2(c))
        c = label + int(num_classes)
        max_len = max(int(num_classes - 1).bit_length(), 1)
        bits = torch.arange(max_len, device=input.device)
        length = torch.floor(torch.log2(c.float())).long()
        valid = (bits[None, :] < length[:, None]).float()
        idx = ((c[:, None] >> (bits[None, :] + 1)) - 1).clamp(
            0, weight.shape[0] - 1)
        pc = ((c[:, None] >> bits[None, :]) & 1).float()
    pre = torch.einsum("nld,nd->nl", weight[idx], input)
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    # BCE with logits against the branch bits, masked to the path length
    per_bit = torch.clamp(pre, min=0) - pre * pc \
        + torch.log1p(torch.exp(-torch.abs(pre)))
    return (per_bit * valid).sum(dim=1, keepdim=True)
