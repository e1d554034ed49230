"""Random ops (counterpart of the reference's ``tensor/random.py``).

Each draws from torch's generator of its device, which ``seed()``
(``core/random.py``) seeds: the CPU generator, or the CUDA generator a
captured step registers, so a replay draws afresh.  The reference's
``key=`` argument (an explicit JAX key) has no counterpart.  Ops with no
tensor input make their result on ``place`` (``None``: ``cuda``, as
``to_tensor``); ``uniform(seed=n)`` with ``n`` not 0 draws from a
generator of its own seeded with ``n``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.device import DeviceLike, resolve_device
from ..core.dtype import convert_dtype

__all__ = ["uniform", "rand", "randn", "standard_normal", "normal",
           "randint", "randperm", "bernoulli", "multinomial", "poisson"]


def _dt(dtype):
    return torch.float32 if dtype is None else convert_dtype(dtype)


def uniform(shape: Sequence[int], dtype=None, min: float = -1.0,
            max: float = 1.0, seed: int = 0, *, place: DeviceLike = None):
    dev = resolve_device(place)
    gen = torch.Generator(device=dev).manual_seed(seed) if seed else None
    out = torch.empty(tuple(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(min, max, generator=gen)


def rand(shape: Sequence[int], dtype=None, *, place: DeviceLike = None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, place=place)


def randn(shape: Sequence[int], dtype=None, *, place: DeviceLike = None):
    return torch.randn(tuple(shape), dtype=_dt(dtype),
                       device=resolve_device(place))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape: Optional[Sequence[int]] = None, *,
           place: DeviceLike = None):
    """Samples of ``mean + std * N(0, 1)``; ``shape`` defaults to the
    broadcast of ``mean``'s and ``std``'s (on their device)."""
    like = mean if torch.is_tensor(mean) else (
        std if torch.is_tensor(std) else None)
    dev = like.device if like is not None else resolve_device(place)
    if shape is None:
        shape = torch.broadcast_shapes(torch.as_tensor(mean).shape,
                                       torch.as_tensor(std).shape)
    return mean + std * torch.randn(tuple(shape), dtype=torch.float32,
                                    device=dev)


def randint(low: int = 0, high: Optional[int] = None,
            shape: Sequence[int] = (1,), dtype="int64", *,
            place: DeviceLike = None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(shape), dtype=convert_dtype(dtype),
                         device=resolve_device(place))


def randperm(n: int, dtype="int64", *, place: DeviceLike = None):
    return torch.randperm(n, dtype=convert_dtype(dtype),
                          device=resolve_device(place))


def bernoulli(x):
    """0/1 draws with probabilities ``x``, in ``x``'s dtype."""
    return torch.bernoulli(x)


def multinomial(x, num_samples: int = 1, replacement: bool = False):
    """Category ids drawn with the probabilities of ``x``'s last axis."""
    return torch.multinomial(x, num_samples, replacement=replacement)


def poisson(x):
    return torch.poisson(x).to(torch.float32)
