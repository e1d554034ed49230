"""Normalization layers (counterpart of the reference's
``nn/layer/norm.py``): ``LayerNorm``, ``BatchNorm`` (the fluid alias with
``act=``) and ``BatchNorm1D/2D/3D``.

A BatchNorm's running statistics are the buffers ``_mean`` (zeros) and
``_variance`` (ones), the reference's names.  In training (without
``use_global_stats``) each forward advances them *in place* by the
reference's rule -- ``momentum * running + (1 - momentum) * batch``, the
batch's biased variance -- so a captured step's replay advances them, and
a recompute's second forward (``functional.norm.frozen_running_stats``)
does not.  ``SyncBatchNorm``, ``GroupNorm``, the instance norms,
``LocalResponseNorm`` and ``SpectralNorm`` are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from ..functional import norm as _norm
from .layers import create_parameter


class LayerNorm(nn.Module):
    """paddle.nn.LayerNorm: weight ones, bias zeros, epsilon 1e-5;
    ``weight_attr``/``bias_attr`` as ``Linear``'s (``False``: none)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = create_parameter(self._normalized_shape, bias_attr,
                                     is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return "normalized_shape=%s, epsilon=%s" % (self._normalized_shape,
                                                    self._epsilon)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = create_parameter(
            [num_features], weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = create_parameter([num_features], bias_attr,
                                     is_bias=True, device=device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def _check_input_dim(self, x):
        pass

    def forward(self, x):
        self._check_input_dim(x)
        out, new_mean, new_var = F._bn_triple(
            x, self._mean, self._variance, self.weight, self.bias,
            self.training, self._momentum, self._epsilon, self._data_format,
            self._use_global_stats)
        if self.training and self._use_global_stats is not True \
                and not _norm.running_stats_frozen():
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out

    def extra_repr(self):
        return "num_features=%d, momentum=%s, epsilon=%s" % (
            self._num_features, self._momentum, self._epsilon)


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm(num_channels) alias; ``act`` names an
    activation of ``nn.functional`` applied after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 device=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def _check_input_dim(self, x):
        if x.ndim not in (2, 3):
            raise InvalidArgumentError(
                "BatchNorm1D expects 2D/3D input, got %dD" % x.ndim)


class BatchNorm2D(_BatchNormBase):
    def _check_input_dim(self, x):
        if x.ndim != 4:
            raise InvalidArgumentError(
                "BatchNorm2D expects 4D input, got %dD" % x.ndim)


class BatchNorm3D(_BatchNormBase):
    def _check_input_dim(self, x):
        if x.ndim != 5:
            raise InvalidArgumentError(
                "BatchNorm3D expects 5D input, got %dD" % x.ndim)
