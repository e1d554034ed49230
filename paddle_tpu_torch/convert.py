"""Carry a reference model's parameters into the port's module.

The port never imports JAX: the caller produces ``{name: np.ndarray}``
from the reference model (its ``named_parameters()`` names), and this
module copies those arrays into the port's module of the same names and
shapes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .core.errors import InvalidArgumentError

__all__ = ["load_reference_params"]


def load_reference_params(model: nn.Module,
                          arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``arrays`` (keyed by the reference's parameter names) into
    ``model``'s parameters of the same names, on the model's device and
    dtype.  Raises :class:`InvalidArgumentError` naming every missing,
    extra or mis-shaped name; nothing is copied unless all names match."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    bad = sorted(
        "%s: reference %s vs port %s" % (n, tuple(np.shape(arrays[n])),
                                         tuple(params[n].shape))
        for n in set(params) & set(arrays)
        if tuple(np.shape(arrays[n])) != tuple(params[n].shape))
    if missing or extra or bad:
        raise InvalidArgumentError(
            "reference parameters do not match the port's module: "
            "missing %s, extra %s, mis-shaped %s" % (missing, extra, bad))
    with torch.no_grad():
        for name, p in params.items():
            # np.array copies: a read-only source buffer stays untouched
            p.copy_(torch.from_numpy(np.array(arrays[name])).to(
                device=p.device, dtype=p.dtype))
    return model
