"""Probability distributions (counterpart of the reference's
``distribution``): ``Uniform``, ``Normal``, ``Categorical`` (over
unnormalized logits), ``MultivariateNormalDiag`` (its ``scale`` a
matrix carrying the diagonal) and ``sampling_id``.

``log_prob``/``probs``/``entropy``/``kl_divergence`` are the reference's
formulas on torch tensors (on the parameters' device).  Samples draw
from a ``torch.Generator``: a fresh one seeded by ``seed`` when it is
nonzero, else the default generator of the parameters' device (which
``seed()`` seeds).  The draws are torch's, not the reference's JAX
streams: they agree with it in distribution (moments), not value by
value.
"""
from __future__ import annotations

import math

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag", "sampling_id"]


def _raw(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, dtype=torch.float32)


def _generator(seed: int, device: torch.device):
    if not seed:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high)."""

    def __init__(self, low, high, name=None):
        self.low = _raw(low)
        self.high = _raw(high)

    def sample(self, shape=(), seed=0):
        base = torch.broadcast_shapes(self.low.shape, self.high.shape)
        dev = self.low.device
        u = torch.rand(tuple(shape) + tuple(base), device=dev,
                       generator=_generator(seed, dev))
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        v = _raw(value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    """N(loc, scale)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _raw(loc)
        self.scale = _raw(scale)

    def _base(self):
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def sample(self, shape=(), seed=0):
        dev = self.loc.device
        z = torch.randn(tuple(shape) + tuple(self._base()), device=dev,
                        generator=_generator(seed, dev))
        return self.loc + z * self.scale

    def entropy(self):
        scale = torch.broadcast_to(self.scale, self._base())
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(scale)

    def log_prob(self, value):
        v = _raw(value)
        var = self.scale * self.scale
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other: "Normal"):
        """KL(self || other)."""
        if not isinstance(other, Normal):
            raise InvalidArgumentError("kl_divergence expects a Normal")
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    """Categories over the last axis of unnormalized ``logits``."""

    def __init__(self, logits, name=None):
        self.logits = _raw(logits)
        if self.logits.dim() < 1:
            raise InvalidArgumentError("Categorical logits must be >= 1-D")

    def _log_p(self):
        return self.logits - torch.logsumexp(self.logits, dim=-1,
                                             keepdim=True)

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)
        batch = tuple(self.logits.shape[:-1])
        k = self.logits.shape[-1]
        n = int(math.prod(shape)) if shape else 1
        p = torch.exp(self._log_p()).reshape(-1, k)
        idx = torch.multinomial(p, n, replacement=True,
                                generator=_generator(seed,
                                                     self.logits.device))
        return idx.t().reshape(shape + batch)

    def entropy(self):
        logp = self._log_p()
        return -(torch.exp(logp) * logp).sum(-1)

    def probs(self, value):
        v = _raw(value).to(torch.int64)
        p = torch.exp(self._log_p())
        if p.dim() == 1:  # one distribution, any shape of value
            return p[v]
        return torch.gather(p, -1, v.unsqueeze(-1)).squeeze(-1)

    def log_prob(self, value):
        return torch.log(self.probs(value))

    def kl_divergence(self, other: "Categorical"):
        if not isinstance(other, Categorical):
            raise InvalidArgumentError(
                "kl_divergence expects a Categorical")
        logp, logq = self._log_p(), other._log_p()
        return (torch.exp(logp) * (logp - logq)).sum(-1)


class MultivariateNormalDiag(Distribution):
    """N(loc, diag(d)) with ``scale`` a (batched) square matrix carrying
    d on its diagonal."""

    def __init__(self, loc, scale, name=None):
        self.loc = _raw(loc)
        self.scale = _raw(scale)
        if self.scale.dim() < 2:
            raise InvalidArgumentError(
                "MultivariateNormalDiag scale must be a (batched) square "
                "matrix carrying the diagonal, got shape %s"
                % (tuple(self.scale.shape),))

    def _diag(self):
        return torch.diagonal(self.scale, dim1=-2, dim2=-1)

    def sample(self, shape=(), seed=0):
        d = self._diag()
        base = torch.broadcast_shapes(self.loc.shape, d.shape)
        dev = self.loc.device
        z = torch.randn(tuple(shape) + tuple(base), device=dev,
                        generator=_generator(seed, dev))
        return self.loc + z * d

    def entropy(self):
        d = self._diag()
        k = d.shape[-1]
        return (0.5 * k * (1.0 + math.log(2 * math.pi))
                + 0.5 * torch.log(torch.prod(d * d, dim=-1)))

    def log_prob(self, value):
        v = _raw(value)
        d = self._diag()
        quad = torch.sum(((v - self.loc) / d) ** 2, dim=-1)
        k = d.shape[-1]
        return (-0.5 * (quad + k * math.log(2 * math.pi))
                - torch.sum(torch.log(d), dim=-1))

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other: "MultivariateNormalDiag"):
        d1, d2 = self._diag(), other._diag()
        var1, var2 = d1 * d1, d2 * d2
        k = d1.shape[-1]
        return 0.5 * (torch.sum(var1 / var2, -1)
                      + torch.sum((self.loc - other.loc) ** 2 / var2, -1)
                      - k + torch.log(torch.prod(var2, -1)
                                      / torch.prod(var1, -1)))


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    """One category id per row of a [batch, V] probability matrix."""
    from ..core.dtype import convert_dtype

    p = _raw(x)
    if p.dim() != 2:
        raise InvalidArgumentError(
            "sampling_id expects [batch, V] probabilities, got %s"
            % (tuple(p.shape),))
    ids = torch.multinomial(p.clamp_min(1e-30), 1,
                            generator=_generator(seed, p.device))
    return ids.squeeze(-1).to(convert_dtype(dtype))
