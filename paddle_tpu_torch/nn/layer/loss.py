"""Loss layers (counterpart of the reference's ``nn/layer/loss.py``): its
twelve layers over the port's ``nn.functional`` losses."""
from __future__ import annotations

import math

from torch import nn

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from .layers import create_parameter


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True,
                 label_smoothing: float = 0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(nn.Module):
    def __init__(self, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction: str = "mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction: str = "mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.bce_loss(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction: str = "mean",
                 pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction: str = "mean", delta: float = 1.0,
                 name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(nn.Module):
    def __init__(self, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin: float = 0.0, reduction: str = "mean",
                 name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(nn.Module):
    def __init__(self, margin: float = 1.0, reduction: str = "mean",
                 name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CTCLoss(nn.Module):
    """nn.CTCLoss over ``F.ctc_loss`` (warpctc semantics)."""

    def __init__(self, blank: int = 0, reduction: str = "mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times: bool = False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class HSigmoidLoss(nn.Module):
    """nn.HSigmoidLoss: holds the [num_classes - 1, feature] internal node
    weights of ``F.hsigmoid_loss``'s complete-binary-tree default (custom
    trees pass ``path_table``/``path_code`` through ``forward``)."""

    def __init__(self, feature_size: int, num_classes: int,
                 weight_attr=None, bias_attr=None, is_custom: bool = False,
                 is_sparse: bool = False, name=None, device=None,
                 generator=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise InvalidArgumentError(
                "num_classes must be >= 2, got %d" % num_classes)
        self.feature_size = feature_size
        self.num_classes = num_classes
        self.is_custom = is_custom
        rows = num_classes if is_custom else num_classes - 1
        std = 1.0 / math.sqrt(feature_size)
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter(
            [rows, feature_size], weight_attr,
            default_initializer=I.Uniform(-std, std), **kw)
        self.bias = create_parameter([rows], bias_attr, is_bias=True, **kw)

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom and (path_table is None or path_code is None):
            raise InvalidArgumentError(
                "is_custom=True needs path_table and path_code")
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)
