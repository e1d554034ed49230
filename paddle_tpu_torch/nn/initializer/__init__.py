"""Weight initializers (counterpart of the reference's
``nn/initializer/__init__.py``): the twelve initializers and
``calculate_gain``.

Each is a callable ``(shape, dtype=None, device=None, generator=None) ->
torch.Tensor``: the reference's ``(shape, dtype)`` plus where to put the
tensor and the ``torch.Generator`` to draw from (``None``: torch's default
generator of that device).  The fans are the reference's for paddle's
layouts (``_fan_in_out``): Linear ``[in, out]``, Conv ``[out, in, *k]``.
The draws are torch's, not the reference's JAX streams (threefry and
torch share none): an initializer agrees with the reference in shape,
fans, bounds and moments, and a seeded generator gives the same draws
each time.  ``XavierNormal`` draws exactly what the port's layers drew
before it existed (one ``normal_`` over the tensor).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ...core.dtype import convert_dtype
from ...core.errors import InvalidArgumentError

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "calculate_gain"]


def _fan_in_out(shape: Sequence[int]):
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = int(shape[0]) if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        # paddle weight layouts: Linear [in, out]; Conv [out, in, *k]
        if len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        else:
            fan_in = shape[1] * receptive
            fan_out = shape[0] * receptive
    return fan_in, fan_out


def _dtype(dtype) -> torch.dtype:
    return torch.float32 if dtype is None else convert_dtype(dtype)


class Initializer:
    def __call__(self, shape, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    @staticmethod
    def _empty(shape, dtype, device):
        return torch.empty(tuple(int(s) for s in shape), dtype=_dtype(dtype),
                           device=device)


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return self._empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return self._empty(shape, dtype, device).normal_(
            self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` a standard normal truncated to [-2, 2]
    (the reference's bounds), by inverting the normal CDF of a uniform
    draw between the bounds' CDF values."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
        t = self._empty(shape, dtype, device).uniform_(lo, hi,
                                                       generator=generator)
        return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(
            self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return self._empty(shape, dtype, device).uniform_(
            self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in: Optional[float] = None,
                 fan_out: Optional[float] = None):
        self._fan_in, self._fan_out = fan_in, fan_out

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self._fan_in if self._fan_in is not None else fi,
                self._fan_out if self._fan_out is not None else fo)

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = self._fans(shape)
        return self._empty(shape, dtype, device).normal_(
            0.0, math.sqrt(2.0 / (fi + fo)), generator=generator)


class XavierUniform(XavierNormal):
    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = self._fans(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        return self._empty(shape, dtype, device).uniform_(
            -limit, limit, generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in: Optional[float] = None,
                 negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return math.sqrt(2.0)

    def _fan(self, shape):
        fi, _ = _fan_in_out(shape)
        return self._fan_in if self._fan_in is not None else fi

    def __call__(self, shape, dtype=None, device=None, generator=None):
        std = self._gain() / math.sqrt(self._fan(shape))
        return self._empty(shape, dtype, device).normal_(
            0.0, std, generator=generator)


class KaimingUniform(KaimingNormal):
    def __call__(self, shape, dtype=None, device=None, generator=None):
        limit = self._gain() * math.sqrt(3.0 / self._fan(shape))
        return self._empty(shape, dtype, device).uniform_(
            -limit, limit, generator=generator)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        arr = torch.as_tensor(np.asarray(self.value), dtype=_dtype(dtype),
                              device=device)
        if tuple(arr.shape) != tuple(shape):
            raise InvalidArgumentError(
                "Assign initializer shape mismatch: %s vs %s"
                % (tuple(arr.shape), tuple(shape)))
        return arr.clone()


class Orthogonal(Initializer):
    """``gain`` times an orthogonal matrix over the last axis, as
    ``jax.nn.initializers.orthogonal``: the Q of a normal draw's QR, its
    columns signed by R's diagonal, transposed when there are fewer rows
    than columns."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise InvalidArgumentError(
                "Orthogonal needs at least 2 dimensions, got %s" % (shape,))
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        a = torch.empty((max(n_rows, n_cols), min(n_rows, n_cols)),
                        dtype=torch.float32, device=device).normal_(
            generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None, generator=None):
        w = np.zeros(shape, dtype=np.float32)
        out_c, in_c = shape[0], shape[1]
        spatial_center = tuple(s // 2 for s in shape[2:])
        for i in range(min(out_c, in_c * self.groups)):
            w[(i, i % in_c) + spatial_center] = 1.0
        return torch.from_numpy(w).to(device=device, dtype=_dtype(dtype))


def calculate_gain(nonlinearity: str, param=None) -> float:
    if nonlinearity in ("sigmoid", "conv1d", "conv2d", "conv3d", "linear"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError("unknown nonlinearity %s" % nonlinearity)
