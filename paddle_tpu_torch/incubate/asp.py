"""ASP, automatic n:m structured sparsity (counterpart of the
reference's ``incubate/asp.py``).

``prune_model`` keeps the ``n`` largest-magnitude weights of every
``m``-group along the reduction axis of each ``Linear`` and ``Conv2D``
weight (those not named by ``set_excluded_layers``, by ``param_name``),
zeroes the rest in place and remembers the mask on the weight's device.
``decorate(optimizer)`` returns an optimizer that re-applies the masks
after every update, so the pruned weights stay zero through training:
after the eager ``step()`` and inside the update a ``TrainStep`` runs
(``_functional_step``, captured into the step's graph on the card).  The
reference's wrapper hands ``_functional_step`` to the inner optimizer
and so loses the pattern under its compiled ``TrainStep``
(ROADMAP queue 3).

The masks are dense: the port does not use the card's 2:4 sparse
tensor cores, as the reference does not.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from ..optimizer import param_name

__all__ = ["compute_nm_mask", "prune_model", "decorate",
           "set_excluded_layers", "reset_excluded_layers", "check_sparsity",
           "OptimizerWithSparsityGuarantee"]

_masks: Dict[str, torch.Tensor] = {}
_excluded: set = set()


def _numpy(w) -> np.ndarray:
    if torch.is_tensor(w):
        return w.detach().float().cpu().numpy()
    return np.asarray(w)


def compute_nm_mask(w, n: int = 2, m: int = 4, axis: int = 0) -> np.ndarray:
    """The boolean mask keeping the ``n`` largest ``|w|`` of every
    ``m``-group along ``axis`` (the reference's numpy, so ties fall as
    there)."""
    w = _numpy(w)
    if w.shape[axis] % m != 0:
        raise InvalidArgumentError(
            "ASP %d:%d needs dim %d (size %d) divisible by %d"
            % (n, m, axis, w.shape[axis], m))
    moved = np.moveaxis(w, axis, -1)
    shape = moved.shape
    groups = moved.reshape(-1, m)
    order = np.argsort(np.abs(groups), axis=1)  # ascending
    mask = np.ones_like(groups, dtype=bool)
    np.put_along_axis(mask, order[:, : m - n], False, axis=1)
    return np.moveaxis(mask.reshape(shape), -1, axis)


def set_excluded_layers(param_names):
    _excluded.update(param_names)


def reset_excluded_layers():
    _excluded.clear()


def _prunable(model):
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D

    for sub in model.modules():
        if isinstance(sub, (Linear, Conv2D)):
            if param_name(sub.weight) not in _excluded:
                yield sub.weight


def prune_model(model, n: int = 2, m: int = 4) -> Dict[str, np.ndarray]:
    """Mask every prunable weight in place; returns ``{param_name:
    mask}``.  A weight whose reduction axis does not divide by ``m`` is
    skipped, as in the reference."""
    out = {}
    for p in _prunable(model):
        axis = 0 if p.dim() == 2 else 1  # Linear [in, out]; conv [o, i, ..]
        if p.shape[axis] % m != 0:
            continue
        mask = compute_nm_mask(p, n, m, axis=axis)
        name = param_name(p)
        held = torch.from_numpy(mask).to(device=p.device, dtype=p.dtype)
        old = _masks.get(name)
        if old is not None and old.shape == held.shape \
                and old.device == held.device and old.dtype == held.dtype:
            old.copy_(held)  # a captured step reads the mask by address
        else:
            _masks[name] = held
        with torch.no_grad():
            p.mul_(_masks[name])
        out[name] = mask
    return out


def check_sparsity(w, n: int = 2, m: int = 4, axis: int = 0) -> bool:
    """Whether every ``m``-group along ``axis`` has at most ``n``
    nonzeros."""
    moved = np.moveaxis(_numpy(w), axis, -1).reshape(-1, m)
    return bool(((moved != 0).sum(axis=1) <= n).all())


class OptimizerWithSparsityGuarantee:
    """An optimizer that re-applies the ASP masks after each update."""

    _OWN = ("_inner",)

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)

    def _apply_masks(self, params):
        with torch.no_grad():
            for p in params:
                mask = _masks.get(getattr(p, "param_name", None))
                if mask is not None:
                    p.mul_(mask)

    def step(self):
        self._inner.step()
        self._apply_masks(self._inner._parameter_list or [])

    def _functional_step(self, params, grads, lr):
        self._inner._functional_step(params, grads, lr)
        self._apply_masks(params)

    def __getattr__(self, name):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    return OptimizerWithSparsityGuarantee(optimizer)
