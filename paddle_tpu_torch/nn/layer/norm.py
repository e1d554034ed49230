"""Normalization layers (counterpart of the reference's
``nn/layer/norm.py``): ``LayerNorm``, ``BatchNorm`` (the fluid alias with
``act=``) and ``BatchNorm1D/2D/3D``.

A BatchNorm's running statistics are the buffers ``_mean`` (zeros) and
``_variance`` (ones), the reference's names.  In training (without
``use_global_stats``) each forward advances them *in place* by the
reference's rule -- ``momentum * running + (1 - momentum) * batch``, the
batch's biased variance -- so a captured step's replay advances them, and
a recompute's second forward (``functional.norm.frozen_running_stats``)
does not.  ``GroupNorm``, ``InstanceNorm1D/2D/3D`` (parameters
``scale`` and ``bias``, as the reference names them),
``LocalResponseNorm`` and ``SpectralNorm`` (its power-iteration vectors
``weight_u``/``weight_v`` are parameters drawn N(0, 1) that take no
gradient and are read, never written, as the reference's op) follow.
``SyncBatchNorm`` reduces its batch statistics over a data-parallel
group's ranks.
"""
from __future__ import annotations

import torch

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from ..functional import norm as _norm
from .layers import Layer, create_parameter


class LayerNorm(Layer):
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


class _BatchNormBase(Layer):
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


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm (the reference's ``SyncBatchNorm``): in
    training the batch statistics are the whole batch's over ``group``'s
    dp ranks (the fleet's dp group when None and fleet is initialized,
    else one rank).  The ranks share one device and own consecutive
    slices of dim 0: each rank's per-channel sum, then its sum of squared
    deviations from the global mean, are reduced in rank order in float32
    (the all-reduces), and every rank normalizes by the result -- one
    ``BatchNorm`` over the global batch, to rounding.  The running
    statistics advance by the reference's rule, with the biased
    variance."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", name=None, device=None,
                 group=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name, device)
        self._group = group

    def _ranks(self) -> int:
        if self._group is not None:
            return self._group.nranks
        from ...distributed.fleet import fleet

        if fleet.is_initialized:
            return fleet.get_hybrid_communicate_group() \
                .get_data_parallel_world_size()
        return 1

    def forward(self, x):
        if not self.training or self._use_global_stats:
            return super().forward(x)
        from ...distributed.collective import rank_sum

        n = self._ranks()
        if x.shape[0] % n:
            raise InvalidArgumentError(
                "SyncBatchNorm: batch %d not divisible by the dp degree %d"
                % (x.shape[0], n))
        axes = _norm._reduce_axes(x, self._data_format)
        ch = [1] * x.ndim
        ch[x.ndim - 1 if self._data_format.endswith("C") and x.ndim > 2
           else 1] = -1
        shards = [s.float() for s in torch.chunk(x, n, dim=0)]
        count = x.numel() // self._num_features
        mean = rank_sum([s.sum(dim=axes) for s in shards]) / count
        var = rank_sum([(s - mean.view(ch)).square().sum(dim=axes)
                        for s in shards]) / count
        out = (x.float() - mean.view(ch)) * torch.rsqrt(
            var.view(ch) + self._epsilon)
        out_dtype = x.dtype
        if self.weight is not None:
            out = out * self.weight.float().view(ch)
            out_dtype = torch.promote_types(out_dtype, self.weight.dtype)
        if self.bias is not None:
            out = out + self.bias.float().view(ch)
        if not _norm.running_stats_frozen():
            with torch.no_grad():
                m = self._momentum
                self._mean.mul_(m).add_(mean.detach().to(self._mean.dtype),
                                        alpha=1 - m)
                self._variance.mul_(m).add_(
                    var.detach().to(self._variance.dtype), alpha=1 - m)
        return out.to(out_dtype)

    @classmethod
    def convert_sync_batchnorm(cls, layer, group=None):
        """``layer`` with every BatchNorm under it (itself included)
        replaced by a ``SyncBatchNorm`` holding its parameters and running
        statistics."""
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format,
                      device=layer._mean.device, group=group)
            new.weight = layer.weight
            new.bias = layer.bias
            new._mean = layer._mean
            new._variance = layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub, group)
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = create_parameter(
            [num_channels], weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = create_parameter([num_channels], bias_attr,
                                     is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = create_parameter(
                [num_features], weight_attr,
                default_initializer=I.Constant(1.0), device=device)
            self.bias = create_parameter([num_features], bias_attr,
                                         is_bias=True, device=device)

    def forward(self, x):
        return F.instance_norm(x, self.scale, self.bias, self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size: int, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 1.0, data_format: str = "NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``forward(weight)``: ``weight / sigma``, sigma from
    ``power_iters`` rounds of power iteration started at the stored
    ``weight_u`` [weight_shape[dim]] and ``weight_v`` [the rest's
    product]."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 epsilon: float = 1e-12, name=None, dtype="float32",
                 device=None, generator=None):
        super().__init__()
        if power_iters < 1:
            raise ValueError("power_iters must be a positive integer")
        self._weight_shape = [int(v) for v in weight_shape]
        self._dim = int(dim) % len(self._weight_shape)
        self._power_iters = int(power_iters)
        self._eps = float(epsilon)
        h = self._weight_shape[self._dim]
        w = 1
        for i, v in enumerate(self._weight_shape):
            if i != self._dim:
                w *= v
        kw = dict(dtype=dtype, default_initializer=I.Normal(0.0, 1.0),
                  device=device, generator=generator)
        self.weight_u = create_parameter([h], **kw)
        self.weight_u.requires_grad_(False)
        self.weight_v = create_parameter([w], **kw)
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        from ..utils import _spectral_normalize

        return _spectral_normalize(weight, self.weight_u, self.weight_v,
                                   self._dim, self._power_iters, self._eps)
