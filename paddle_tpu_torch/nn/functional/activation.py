"""Activation functionals (counterpart of the reference's
``nn/functional/activation.py``): its 28 activations, with its formulas
where they differ from torch's defaults -- ``gelu``'s ``approximate``
flag, ``hardsigmoid``'s slope 0.1666667 and offset 0.5, ``selu``'s and
``softplus``'s parameters, ``prelu``'s per-channel weight on axis 1,
``softmax``/``log_softmax``'s ``dtype=`` (the input cast first).
``relu_`` writes its result into ``x``, as paddle's in-place op (the
reference, whose arrays are immutable, returns a new one).
``gumbel_softmax`` draws from torch's generator of ``x``'s device, not
the reference's JAX stream."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.dtype import convert_dtype


def relu(x):
    return torch.relu(x)


def relu6(x):
    return tF.relu6(x)


def relu_(x):
    return torch.relu_(x)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate: bool = False):
    """GELU: exact (erf) by default, the tanh form with ``approximate``,
    as the reference's ``jax.nn.gelu``."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope: float = 0.01):
    return tF.leaky_relu(x, negative_slope)


def elu(x, alpha: float = 1.0):
    return tF.elu(x, alpha)


def selu(x, scale: float = 1.0507009873554804934193349852946,
         alpha: float = 1.6732632423543772848170429916717):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def silu(x):
    return tF.silu(x)


def swish(x):
    return tF.silu(x)


def mish(x):
    return tF.mish(x)


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    return tF.softplus(x, beta, threshold)


def softsign(x):
    return tF.softsign(x)


def softshrink(x, threshold: float = 0.5):
    return tF.softshrink(x, threshold)


def hardshrink(x, threshold: float = 0.5):
    return tF.hardshrink(x, threshold)


def hardtanh(x, min: float = -1.0, max: float = 1.0):
    return tF.hardtanh(x, min, max)


def hardsigmoid(x, slope: float = 0.1666667, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return tF.hardswish(x)


def tanhshrink(x):
    return tF.tanhshrink(x)


def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def log_sigmoid(x):
    return tF.logsigmoid(x)


def maxout(x, groups: int, axis: int = 1):
    shape = list(x.shape)
    axis = axis % x.ndim
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


def prelu(x, weight):
    w = weight
    if w.ndim == 1 and w.shape[0] > 1 and x.ndim > 2:
        # per-channel weight broadcasts over NCHW channel axis
        w = w.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x > 0, x, w * x)


def softmax(x, axis: int = -1, dtype=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1, dtype=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1):
    g = -torch.log(-torch.log(torch.rand_like(x).clamp_(
        torch.finfo(x.dtype).tiny, 1.0)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        hard_y = torch.zeros_like(y).scatter_(
            axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = (hard_y - y).detach() + y
    return y


def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)
