"""Weight reparameterization hooks (counterpart of the reference's
``nn/utils/__init__.py``): ``spectral_norm``, ``weight_norm`` and
``remove_weight_norm``, and ``_spectral_normalize``, which the
``SpectralNorm`` layer runs.

Both hooks move the raw parameter to ``<name>_orig`` (spectral norm, with
the buffers ``<name>_u``/``<name>_v``) or to ``<name>_g``/``<name>_v``
(weight norm), and recompute ``<name>`` as a plain tensor attribute in a
forward pre-hook, so each call's weight is in autograd's graph while the
power-iteration vectors stay out of it.  A spectral-norm hook runs its
power iteration (and writes u/v back) only in training, as the
reference's; ``<name>_u``/``<name>_v`` start as normalized N(0, 1) draws
from ``generator`` (the reference's come from an unseeded numpy
generator: carry them across with ``load_reference_params``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["spectral_norm", "weight_norm", "remove_weight_norm"]


def _reshape_to_matrix(weight, dim: int):
    """``dim`` moved to the front and the rest flattened: [h, w]."""
    dim = dim % weight.ndim
    if dim != 0:
        weight = weight.permute([dim] + [d for d in range(weight.ndim)
                                         if d != dim])
    return weight.reshape(weight.shape[0], -1)


def _l2normalize(x, eps):
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def _spectral_normalize(weight, u, v, dim, power_iters, eps,
                        write_back: bool = False):
    """``weight / sigma`` with ``sigma = u^T W v`` after ``power_iters``
    rounds of power iteration from ``u``/``v``.  The rounds run outside
    autograd and their ``u``/``v`` enter sigma as constants, so the
    gradient flows through ``weight`` only; ``write_back`` stores them."""
    w_mat = _reshape_to_matrix(weight, dim)
    with torch.no_grad():
        w_raw = w_mat.detach()
        u_raw, v_raw = u.detach(), v.detach()
        for _ in range(power_iters):
            v_raw = _l2normalize(torch.mv(w_raw.t(), u_raw), eps)
            u_raw = _l2normalize(torch.mv(w_raw, v_raw), eps)
        if write_back:
            u.copy_(u_raw)
            v.copy_(v_raw)
        u_raw, v_raw = u_raw.clone(), v_raw.clone()
    sigma = torch.dot(u_raw, torch.mv(w_mat, v_raw))
    return weight / sigma


def _hooks(layer, cls):
    return [h for h in layer._forward_pre_hooks.values()
            if isinstance(h, cls)]


class _SpectralNormHook:
    def __init__(self, name, n_power_iterations, dim, eps):
        if n_power_iterations <= 0:
            raise ValueError(
                "Expected n_power_iterations to be positive, got %r"
                % (n_power_iterations,))
        self.name = name
        self.dim = dim
        self.n_power_iterations = n_power_iterations
        self.eps = eps

    def compute_weight(self, layer, do_power_iteration):
        return _spectral_normalize(
            getattr(layer, self.name + "_orig"),
            getattr(layer, self.name + "_u"),
            getattr(layer, self.name + "_v"), self.dim,
            self.n_power_iterations if do_power_iteration else 0,
            self.eps, write_back=do_power_iteration)

    def __call__(self, layer, inputs):
        setattr(layer, self.name,
                self.compute_weight(layer, do_power_iteration=layer.training))

    @staticmethod
    def apply(layer, name, n_power_iterations, dim, eps, generator=None):
        if any(h.name == name for h in _hooks(layer, _SpectralNormHook)):
            raise RuntimeError("Cannot register two spectral_norm hooks on "
                               "the same parameter %s" % name)
        fn = _SpectralNormHook(name, n_power_iterations, dim, eps)
        weight = layer._parameters[name]
        h, w = _reshape_to_matrix(weight, dim).shape
        kw = dict(dtype=weight.dtype, device=weight.device,
                  generator=generator)
        with torch.no_grad():
            u0 = _l2normalize(torch.randn(h, **kw), eps)
            v0 = _l2normalize(torch.randn(w, **kw), eps)
        del layer._parameters[name]
        layer.register_parameter(name + "_orig", weight)
        setattr(layer, name, weight * 1.0)
        layer.register_buffer(name + "_u", u0)
        layer.register_buffer(name + "_v", v0)
        layer.register_forward_pre_hook(fn)
        return fn


def spectral_norm(layer: nn.Module, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: Optional[int] = None,
                  generator: Optional[torch.Generator] = None):
    """Spectral normalization of ``layer.<name>``; ``dim`` defaults to 1
    for ``Linear`` (its weight is [in, out]) and the transposed
    convolutions, else 0."""
    if dim is None:
        from ..layer.common import Linear
        from ..layer.conv import (Conv1DTranspose, Conv2DTranspose,
                                  Conv3DTranspose)

        dim = 1 if isinstance(layer, (Conv1DTranspose, Conv2DTranspose,
                                      Conv3DTranspose, Linear)) else 0
    _SpectralNormHook.apply(layer, name, n_power_iterations, dim, eps,
                            generator)
    return layer


def _norm_except_dim(w, dim):
    """||w|| over every axis but ``dim`` (``dim`` -1: a scalar)."""
    if dim == -1:
        return torch.linalg.vector_norm(w)
    return torch.linalg.vector_norm(_reshape_to_matrix(w, dim), dim=1)


def _weight_norm_compute(v, g, dim):
    """``g * v / ||v||`` (the norm over every axis but ``dim``),
    differentiable in both."""
    if dim == -1:
        return v * (g / torch.sqrt((v * v).sum()))
    axes = [d for d in range(v.ndim) if d != dim]
    norm = torch.sqrt((v * v).sum(dim=axes, keepdim=True))
    shape = [1] * v.ndim
    shape[dim] = -1
    return v / norm * g.reshape(shape)


class _WeightNormHook:
    def __init__(self, name, dim):
        self.name = name
        self.dim = -1 if dim is None else dim

    def compute_weight(self, layer):
        return _weight_norm_compute(getattr(layer, self.name + "_v"),
                                    getattr(layer, self.name + "_g"),
                                    self.dim)

    def __call__(self, layer, inputs):
        setattr(layer, self.name, self.compute_weight(layer))

    @staticmethod
    def apply(layer, name, dim):
        if any(h.name == name for h in _hooks(layer, _WeightNormHook)):
            raise RuntimeError("Cannot register two weight_norm hooks on "
                               "the same parameter %s" % name)
        if dim is None:
            dim = -1
        w = layer._parameters[name]
        ndim = w.ndim
        if not -ndim <= dim < ndim:
            raise ValueError("dim must be in [-R, R), R = weight rank %d"
                             % ndim)
        if dim != -1:
            dim = (dim + ndim) % ndim
        fn = _WeightNormHook(name, dim)
        with torch.no_grad():
            g0 = _norm_except_dim(w.detach(), dim)
        del layer._parameters[name]
        layer.register_parameter(name + "_g", nn.Parameter(g0))
        layer.register_parameter(name + "_v", w)
        setattr(layer, name, w * 1.0)
        layer.register_forward_pre_hook(fn)
        return fn

    def remove(self, layer):
        with torch.no_grad():
            w = self.compute_weight(layer).detach().clone()
        delattr(layer, self.name + "_g")
        delattr(layer, self.name + "_v")
        layer.__dict__.pop(self.name, None)
        layer.register_parameter(self.name, nn.Parameter(w))


def weight_norm(layer: nn.Module, name: str = "weight", dim: int = 0):
    """``layer.<name>`` as magnitude ``<name>_g`` times direction
    ``<name>_v / ||<name>_v||``."""
    _WeightNormHook.apply(layer, name, dim)
    return layer


def remove_weight_norm(layer: nn.Module, name: str = "weight"):
    """Fold the g/v reparameterization back into one parameter."""
    for hook_id, hook in list(layer._forward_pre_hooks.items()):
        if isinstance(hook, _WeightNormHook) and hook.name == name:
            hook.remove(layer)
            del layer._forward_pre_hooks[hook_id]
            return layer
    raise ValueError("weight_norm of %r not found in %r" % (name, layer))
