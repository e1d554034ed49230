"""Dtype names <-> torch dtypes (counterpart of the reference's
``core/dtype.py``).

The reference speaks numpy/jnp dtype names (``"float32"``, ``"int8"``);
the port keeps those names at its public surface and maps them onto torch
dtypes here, in one place.
"""
from __future__ import annotations

from typing import Any

import torch

from .errors import InvalidArgumentError

_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
}

_NAMES = {
    torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
}


def convert_dtype(dtype: Any) -> torch.dtype:
    """A dtype name or a ``torch.dtype`` as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    key = str(dtype).lower()
    if key not in _ALIASES:
        raise InvalidArgumentError("unknown dtype %r" % (dtype,))
    return _ALIASES[key]


def dtype_name(dtype: Any) -> str:
    """The reference's name for a dtype (``torch.float32`` -> ``"float32"``)."""
    return _NAMES[convert_dtype(dtype)]
