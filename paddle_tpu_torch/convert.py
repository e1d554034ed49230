"""Carry a reference model's parameters and buffers into the port's
module.

The port never imports JAX: the caller produces ``{name: np.ndarray}``
from the reference model (its ``named_parameters()`` names, and its
``named_buffers()`` names where it has floating buffers: a BatchNorm's
``bn1._mean``/``bn1._variance``), and this module copies those arrays
into the port's parameters and floating buffers of the same names and
shapes.  bf16 arrays (numpy dtype ``bfloat16``, as ``np.asarray`` gives
for a bf16 JAX array) cross bit for bit, viewed through int16 so that no
``ml_dtypes`` import is needed.

A model already placed on a ``DecodeMesh`` (a session or pool built over
it) gets its mp weight slices refreshed from the loaded parameters: the
reference's parameters load into the unsharded model, and the mesh shards
them.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .core.errors import InvalidArgumentError

__all__ = ["load_reference_params"]


def _as_torch(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the array ``a``; bf16 bit for bit."""
    a = np.array(a)  # a copy: a read-only source buffer stays untouched
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_reference_params(model: nn.Module,
                          arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``arrays`` (keyed by the reference's parameter and buffer
    names) into ``model``'s parameters and floating buffers of the same
    names, on the model's device and dtype.  Raises
    :class:`InvalidArgumentError` naming every missing, extra or
    mis-shaped name; nothing is copied unless all names match."""
    params = dict(model.named_parameters())
    params.update((n, b) for n, b in model.named_buffers()
                  if b.is_floating_point())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    bad = sorted(
        "%s: reference %s vs port %s" % (n, tuple(np.shape(arrays[n])),
                                         tuple(params[n].shape))
        for n in set(params) & set(arrays)
        if tuple(np.shape(arrays[n])) != tuple(params[n].shape))
    if missing or extra or bad:
        raise InvalidArgumentError(
            "reference parameters and buffers do not match the port's "
            "module: "
            "missing %s, extra %s, mis-shaped %s" % (missing, extra, bad))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_as_torch(arrays[name]).to(device=p.device,
                                               dtype=p.dtype))
    from .jit.mesh import refresh_placed
    refresh_placed(model)
    return model
