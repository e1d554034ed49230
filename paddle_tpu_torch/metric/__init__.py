"""Evaluation metrics (counterpart of the reference's ``metric``):
``Metric``, ``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc``
(ROC over 4095 threshold buckets) and the functional ``accuracy``.

The accumulators live on the host in numpy, as the reference's: a
batch's predictions and labels are read back once (``compute``, or
``update`` when called directly), and the arithmetic is the reference's
numpy, so the same arrays give the same values.  ``accuracy`` stays on
the tensor's device and ranks with a stable sort, so a tie goes to the
lower index as under the reference's ``jnp.argsort``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.errors import InvalidArgumentError

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    """reset / update / accumulate / name, and ``compute`` (a batch's
    outputs to ``update``'s input; by default passed through)."""

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``."""

    def __init__(self, topk: Union[int, Sequence[int]] = (1,),
                 name: Optional[str] = None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name_prefix = name or "acc"
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        order = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        return order == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0] if correct.ndim else 1
        for i, k in enumerate(self.topk):
            self.total[i] += float(correct[..., :k].any(axis=-1).sum())
        self.count += num
        res = [self.total[i] / max(self.count, 1)
               for i in range(len(self.topk))]
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(self.count, 1) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1 and self.topk[0] == 1:
            return [self._name_prefix]
        return ["%s_top%d" % (self._name_prefix, k) for k in self.topk]


class Precision(Metric):
    """Binary precision of ``preds > 0.5``."""

    def __init__(self, name: Optional[str] = None):
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds).ravel()
        labels = _np(labels).ravel()
        pos = preds > 0.5
        self.tp += int(np.logical_and(pos, labels == 1).sum())
        self.fp += int(np.logical_and(pos, labels == 0).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of ``preds > 0.5``."""

    def __init__(self, name: Optional[str] = None):
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds).ravel()
        labels = _np(labels).ravel()
        pos = preds > 0.5
        self.tp += int(np.logical_and(pos, labels == 1).sum())
        self.fn += int(np.logical_and(~pos, labels == 1).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC by the trapezoid over ``num_thresholds + 1`` buckets of the
    positive class's probability (a [N, 2] input's second column)."""

    def __init__(self, curve: str = "ROC", num_thresholds: int = 4095,
                 name: Optional[str] = None):
        if curve != "ROC":
            raise InvalidArgumentError(
                "only ROC AUC is supported, got %r" % curve)
        self.num_thresholds = int(num_thresholds)
        self._name = name or "auc"
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).ravel()
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.ravel()
        buckets = np.clip((preds * self.num_thresholds).astype(np.int64),
                          0, self.num_thresholds)
        np.add.at(self._stat_pos, buckets[labels == 1], 1)
        np.add.at(self._stat_neg, buckets[labels != 1], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        area = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return float(area / (tot_pos * tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k: int = 1, correct=None, total=None, name=None):
    """The top-``k`` accuracy of ``input`` [N, C] against ``label`` as a
    float32 scalar tensor on ``input``'s device (no gradient)."""
    with torch.no_grad():
        topk = torch.argsort(-input, dim=-1, stable=True)[..., :k]
        hit = (topk == label.reshape(-1, 1)).any(dim=-1)
        return hit.to(torch.float32).mean()
