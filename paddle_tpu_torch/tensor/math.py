"""Elementwise and reduction math (counterpart of the reference's
``tensor/math.py``): its names and arguments (``axis=``, ``keepdim=``),
each a torch composition of the reference's formula.  ``axis=None``
reduces every axis; an axis may be an int or a list."""
from __future__ import annotations

import torch

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "kron", "outer", "lerp", "abs", "exp", "expm1", "log", "log1p", "log2",
    "log10", "sqrt", "rsqrt", "square", "reciprocal", "sin", "cos", "tan",
    "sinh", "cosh", "tanh", "stanh", "asin", "acos", "atan", "atan2",
    "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid", "lgamma",
    "digamma", "logit", "frac", "nan_to_num", "deg2rad", "rad2deg", "gcd",
    "lcm", "heaviside", "diff", "ceil", "floor", "round", "trunc", "sign",
    "clip", "scale", "increment", "sum", "nansum", "mean", "nanmean",
    "prod", "max", "min", "amax", "amin", "all", "any", "logsumexp", "std",
    "var", "cumsum", "cumprod", "add_n", "trace", "neg", "conj", "mm",
    "addmm", "inverse", "diagonal", "multiplex"]


def _dims(x, axis):
    """``axis`` as a tuple of dims; every dim when None."""
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def _dtype(dtype):
    from ..core.dtype import convert_dtype

    return None if dtype is None else convert_dtype(dtype)


# -- elementwise binary ------------------------------------------------------


def add(x, y):
    return torch.add(x, y)


def subtract(x, y):
    return torch.subtract(x, y)


def multiply(x, y):
    return torch.multiply(x, y)


def divide(x, y):
    return torch.true_divide(x, y)


def floor_divide(x, y):
    return torch.floor_divide(x, y)


def mod(x, y):
    """The result takes the divisor's sign (Python's and numpy's mod)."""
    return torch.remainder(x, y)


remainder = mod


def floor_mod(x, y):
    """Alias of mod."""
    return torch.remainder(x, y)


def pow(x, y):
    return torch.pow(x, y)


def maximum(x, y):
    return torch.maximum(x, y)


def minimum(x, y):
    return torch.minimum(x, y)


def fmax(x, y):
    return torch.fmax(x, y)


def fmin(x, y):
    return torch.fmin(x, y)


def kron(x, y):
    return torch.kron(x, y)


def outer(x, y):
    """Outer product of the flattened inputs."""
    return torch.outer(x.reshape(-1), y.reshape(-1))


def lerp(x, y, weight):
    return x + weight * (y - x)


# -- elementwise unary -------------------------------------------------------


def abs(x):
    return torch.abs(x)


def exp(x):
    return torch.exp(x)


def expm1(x):
    return torch.expm1(x)


def log(x):
    return torch.log(x)


def log1p(x):
    return torch.log1p(x)


def log2(x):
    return torch.log2(x)


def log10(x):
    return torch.log10(x)


def sqrt(x):
    return torch.sqrt(x)


def rsqrt(x):
    return torch.reciprocal(torch.sqrt(x))


def square(x):
    return torch.square(x)


def reciprocal(x):
    return torch.reciprocal(x)


def sin(x):
    return torch.sin(x)


def cos(x):
    return torch.cos(x)


def tan(x):
    return torch.tan(x)


def sinh(x):
    return torch.sinh(x)


def cosh(x):
    return torch.cosh(x)


def tanh(x):
    return torch.tanh(x)


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * x)


def asin(x):
    return torch.asin(x)


def acos(x):
    return torch.acos(x)


def atan(x):
    return torch.atan(x)


def atan2(x, y):
    return torch.atan2(x, y)


def asinh(x):
    return torch.asinh(x)


def acosh(x):
    return torch.acosh(x)


def atanh(x):
    return torch.atanh(x)


def erf(x):
    return torch.erf(x)


def erfinv(x):
    return torch.erfinv(x)


def sigmoid(x):
    return torch.sigmoid(x)


def lgamma(x):
    return torch.lgamma(x)


def digamma(x):
    return torch.digamma(x)


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def frac(x):
    return x - torch.trunc(x)


def nan_to_num(x, nan: float = 0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def deg2rad(x):
    return torch.deg2rad(x)


def rad2deg(x):
    return torch.rad2deg(x)


def gcd(x, y):
    return torch.gcd(x, y)


def lcm(x, y):
    return torch.lcm(x, y)


def heaviside(x, y):
    return torch.heaviside(x, y)


def diff(x, n: int = 1, axis: int = -1, prepend=None, append=None):
    """n-th forward difference along ``axis``; a scalar ``prepend`` or
    ``append`` is one slice of that value."""
    def edge(v):
        if v is None or (torch.is_tensor(v) and v.ndim == x.ndim):
            return v
        shape = list(x.shape)
        shape[axis] = 1
        return torch.full(shape, float(v) if x.is_floating_point() else v,
                          dtype=x.dtype, device=x.device)

    return torch.diff(x, n=n, dim=axis, prepend=edge(prepend),
                      append=edge(append))


def ceil(x):
    return torch.ceil(x)


def floor(x):
    return torch.floor(x)


def round(x):
    """Half to even, as numpy's."""
    return torch.round(x)


def trunc(x):
    return torch.trunc(x)


def sign(x):
    return torch.sign(x)


def clip(x, min=None, max=None):
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def scale(x, scale=1.0, bias=0.0, bias_after_scale: bool = True):
    """paddle.scale: ``x * scale + bias``, or ``(x + bias) * scale``."""
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def increment(x, value=1.0):
    return x + value


# -- reductions --------------------------------------------------------------


def sum(x, axis=None, dtype=None, keepdim: bool = False):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim,
                     dtype=_dtype(dtype))


def nansum(x, axis=None, dtype=None, keepdim: bool = False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim,
                        dtype=_dtype(dtype))


def mean(x, axis=None, keepdim: bool = False):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim: bool = False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


def _each_dim(fn, x, axis, keepdim):
    """``fn(x, dim, keepdim)`` over each dim of ``axis``, for the torch
    reductions that take one dim at a time."""
    for d in sorted((d % x.ndim for d in _dims(x, axis)), reverse=True):
        x = fn(x, d, keepdim)
    return x


def prod(x, axis=None, keepdim: bool = False, dtype=None):
    if dtype is not None:
        x = x.to(_dtype(dtype))
    if x.ndim == 0:
        return x.clone()
    return _each_dim(lambda t, d, k: torch.prod(t, dim=d, keepdim=k), x,
                     axis, keepdim)


def max(x, axis=None, keepdim: bool = False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim: bool = False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax = max
amin = min


def all(x, axis=None, keepdim: bool = False):
    x = x.bool()
    if x.ndim == 0:
        return x.clone()
    return _each_dim(lambda t, d, k: torch.all(t, dim=d, keepdim=k), x,
                     axis, keepdim)


def any(x, axis=None, keepdim: bool = False):
    x = x.bool()
    if x.ndim == 0:
        return x.clone()
    return _each_dim(lambda t, d, k: torch.any(t, dim=d, keepdim=k), x,
                     axis, keepdim)


def logsumexp(x, axis=None, keepdim: bool = False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased: bool = True, keepdim: bool = False):
    return torch.std(x, dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def var(x, axis=None, unbiased: bool = True, keepdim: bool = False):
    return torch.var(x, dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def cumsum(x, axis=None, dtype=None):
    """Along ``axis``; over the flattened tensor when None."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=_dtype(dtype))


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim, dtype=_dtype(dtype))


def add_n(inputs):
    """The sum of a list of tensors."""
    if not isinstance(inputs, (list, tuple)):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


def trace(x, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def neg(x):
    return torch.neg(x)


def conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


def mm(input, mat2):
    """Matrix product without broadcasting."""
    return torch.matmul(input, mat2)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    """``beta * input + alpha * (x @ y)``."""
    return beta * input + alpha * torch.matmul(x, y)


def inverse(x):
    """Batched square-matrix inverse."""
    return torch.linalg.inv(x)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def multiplex(inputs, index):
    """Row r of the output is row r of ``inputs[index[r]]``."""
    stacked = torch.stack(list(inputs))  # [K, N, ...]
    idx = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]
