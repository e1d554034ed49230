"""Normalization functionals (counterpart of the reference's
``nn/functional/norm.py``): ``layer_norm``, ``batch_norm_stats`` and
``batch_norm`` (the reference's pure triple-return form), and
``batch_norm_``, the in-place form the public ``F.batch_norm`` and the
BatchNorm layers run; ``instance_norm`` and ``group_norm`` (channels
first, the biased variance, ``epsilon`` inside the square root),
``local_response_norm`` (across channels: ``x / (k + alpha * sum / size)
^ beta`` over a window padded ``(size // 2, size - size // 2 - 1)``) and
``normalize`` (``x / max(||x||_p, epsilon)``)."""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as tF


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Layer norm over the trailing ``normalized_shape`` axes with the
    biased variance and ``epsilon`` inside the square root, rounded where
    the reference's ``jnp.mean``/``jnp.var`` round: for a 16-bit ``x``
    both statistics are computed in float32 (the variance about the
    float32 mean) and returned in ``x``'s dtype, and the normalizer is
    ``1 / sqrt`` in that dtype; float32 takes ``rsqrt`` (one launch,
    within an ulp of it).  A bf16 ``x`` times float32 weights comes out
    float32, as in JAX."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    half = x.dtype in (torch.float16, torch.bfloat16)
    xf = x.float() if half else x
    mean32 = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean32).square().mean(dim=axes, keepdim=True).to(x.dtype)
    mean = mean32.to(x.dtype)
    norm = (torch.reciprocal(torch.sqrt(var + epsilon)) if half
            else torch.rsqrt(var + epsilon))
    out = (x - mean) * norm
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


# -- batch normalization ------------------------------------------------------

_HALF = (torch.float16, torch.bfloat16)
_FROZEN = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, ``batch_norm`` normalizes as it would but writes no running
    statistics: recompute's second forward (``distributed.fleet.utils.
    recompute``) runs under it, so a step advances them once.  The flag is
    per thread (a recompute runs on the thread that runs the backward)."""
    prev = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = prev


def running_stats_frozen() -> bool:
    return getattr(_FROZEN, "on", False)


def _reduce_axes(x, data_format):
    if data_format.endswith("C") and x.ndim > 2:
        return tuple(i for i in range(x.ndim) if i != x.ndim - 1)
    return tuple(i for i in range(x.ndim) if i != 1) if x.ndim > 1 else (0,)


def batch_norm_stats(x, data_format: str = "NCHW"):
    """The batch mean and biased variance of each channel."""
    var, mean = torch.var_mean(x, dim=_reduce_axes(x, data_format),
                               correction=0)
    return mean, var


def _channels_first(x, data_format):
    """``x`` with channels on axis 1 (a view), and the inverse permutation
    (None when ``x`` was channels-first already)."""
    if data_format.endswith("C") and x.ndim > 2:
        perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
        inv = (0,) + tuple(range(2, x.ndim)) + (1,)
        return x.permute(perm), inv
    return x, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats: Optional[bool] = None):
    """Returns ``(out, new_running_mean, new_running_var)``, the
    reference's pure form.  With batch statistics (``training`` and not
    ``use_global_stats``) the new running values are ``momentum * running
    + (1 - momentum) * batch`` with the batch's *biased* variance, as the
    reference's ``jnp.var``; otherwise they are the running tensors
    themselves.  The output's dtype is the reference's promotion: a
    16-bit ``x`` with float32 weights (O2: norms stay float32) comes out
    float32.

    One ``torch.nn.functional.batch_norm`` call does the work (cuDNN or
    ATen's fused kernel on the card; a 16-bit ``x`` reads float32
    parameters as it is).  Its own running update is the other rule
    (momentum on the new value, the unbiased variance), so it is given
    scratch buffers at momentum 1, which it fills with the batch mean and
    unbiased variance; the reference's update is made from those with no
    second pass over ``x``."""
    batch_stats = training and not use_global_stats
    out_dtype = x.dtype
    for t in ([weight, bias] if batch_stats
              else [weight, bias, running_mean, running_var]):
        if t is not None:
            out_dtype = torch.promote_types(out_dtype, t.dtype)
    params = [t for t in (weight, bias) if t is not None]
    if not batch_stats:
        params += [running_mean, running_var]
    pdtype = params[0].dtype if params else (
        torch.float32 if x.dtype in _HALF else x.dtype)
    if any(t.dtype != pdtype for t in params) or not (
            pdtype == x.dtype or (x.dtype in _HALF
                                  and pdtype == torch.float32)):
        # no torch kernel takes these dtypes together: run in the output's
        x = x.to(out_dtype)
        pdtype = out_dtype
    cast = (lambda t: None if t is None else t.to(pdtype))
    xc, inv = _channels_first(x, data_format)
    if batch_stats:
        c = xc.shape[1]
        mean = torch.zeros(c, dtype=pdtype, device=x.device)
        var = torch.zeros(c, dtype=pdtype, device=x.device)
        out = tF.batch_norm(xc, mean, var, cast(weight), cast(bias), True,
                            1.0, epsilon)
        n = xc.numel() // c
        with torch.no_grad():
            new_mean = torch.add(running_mean * momentum,
                                 mean.to(running_mean.dtype),
                                 alpha=1.0 - momentum)
            # var holds the unbiased variance: times (n - 1) / n is the
            # biased one the reference keeps
            new_var = torch.add(running_var * momentum,
                                var.to(running_var.dtype),
                                alpha=(1.0 - momentum) * (n - 1) / n)
    else:
        out = tF.batch_norm(xc, cast(running_mean), cast(running_var),
                            cast(weight), cast(bias), False, 0.0, epsilon)
        new_mean, new_var = running_mean, running_var
    if inv is not None:
        out = out.permute(inv)
    return out.to(out_dtype), new_mean, new_var


def batch_norm_(x, running_mean, running_var, weight=None, bias=None,
                training: bool = False, momentum: float = 0.9,
                epsilon: float = 1e-5, data_format: str = "NCHW",
                use_global_stats: Optional[bool] = None, name=None):
    """paddle's ``F.batch_norm``: the output, with ``running_mean`` and
    ``running_var`` advanced in place when batch statistics are used
    (not while ``frozen_running_stats`` is on).  In place, so a captured
    step's replay advances them."""
    out, new_mean, new_var = batch_norm(
        x, running_mean, running_var, weight, bias, training, momentum,
        epsilon, data_format, use_global_stats)
    if training and use_global_stats is not True \
            and not running_stats_frozen():
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    return out


# -- instance, group and response normalization ------------------------------

def _affine_channels(out, weight, bias):
    cshape = (1, -1) + (1,) * (out.ndim - 2)
    if weight is not None:
        out = out * weight.reshape(cshape)
    if bias is not None:
        out = out + bias.reshape(cshape)
    return out


def _check_channels_first(data_format, name):
    if not data_format.startswith("NC"):
        from ...core.errors import InvalidArgumentError

        raise InvalidArgumentError(
            "%s supports channel-first layouts only" % name)


def instance_norm(x, weight=None, bias=None, eps: float = 1e-5,
                  data_format: str = "NCHW"):
    """Each (sample, channel) normalized over its spatial positions."""
    _check_channels_first(data_format, "instance_norm")
    axes = tuple(range(2, x.ndim))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    return _affine_channels((x - mean) * torch.rsqrt(var + eps), weight,
                            bias)


def group_norm(x, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-5, data_format: str = "NCHW"):
    """Each sample's channels in ``num_groups`` groups, each group
    normalized over its channels and positions."""
    from ...core.errors import InvalidArgumentError

    _check_channels_first(data_format, "group_norm")
    n, c = x.shape[:2]
    if c % num_groups:
        raise InvalidArgumentError("channels %d not divisible by num_groups "
                                   "%d" % (c, num_groups))
    g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.ndim))
    var, mean = torch.var_mean(g, dim=axes, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine_channels(out, weight, bias)


def local_response_norm(x, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW"):
    """Across-channel LRN on axis 1 (the reference reads axis 1 whatever
    ``data_format`` says): the squares summed over a window of ``size``
    channels, averaged, as the reference's."""
    half = size // 2
    pads = [0, 0] * (x.ndim - 2) + [half, size - half - 1]
    sq = tF.pad(x * x, pads)
    windows = sq.unfold(1, size, 1).sum(dim=-1)
    return x / torch.pow(k + alpha * windows / size, beta)


def normalize(x, p: float = 2, axis: int = 1, epsilon: float = 1e-12):
    """``x`` over its ``p``-norm along ``axis``, the norm floored at
    ``epsilon``."""
    norm = torch.pow(torch.pow(x.abs(), p).sum(dim=axis, keepdim=True),
                     1.0 / p)
    return x / torch.clamp(norm, min=epsilon)
