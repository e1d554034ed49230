"""Py2/py3 compatibility helpers (``paddle.compat``; a copy of the
reference's ``compat.py``).

Under python3 these are thin text/bytes coercions and a round half away
from zero.  Host-side only.
"""
from __future__ import annotations

import math

__all__ = []  # matches the reference: importable, not re-exported


def to_text(obj, encoding="utf-8", inplace=False):
    """Coerce ``obj`` (str/bytes or a list/set/dict of them) to ``str``."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_to_text(x, encoding) for x in obj]
            return obj
        return [_to_text(x, encoding) for x in obj]
    if isinstance(obj, set):
        if inplace:
            items = [_to_text(x, encoding) for x in obj]
            obj.clear()
            obj.update(items)
            return obj
        return {_to_text(x, encoding) for x in obj}
    if isinstance(obj, dict):
        if inplace:
            new = {_to_text(k, encoding): _to_text(v, encoding)
                   for k, v in obj.items()}
            obj.clear()
            obj.update(new)
            return obj
        return {_to_text(k, encoding): _to_text(v, encoding)
                for k, v in obj.items()}
    return _to_text(obj, encoding)


def _to_text(obj, encoding):
    if obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj).decode(encoding)
    return str(obj)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """Coerce ``obj`` (str/bytes or a list/set of them) to ``bytes``."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_to_bytes(x, encoding) for x in obj]
            return obj
        return [_to_bytes(x, encoding) for x in obj]
    if isinstance(obj, set):
        if inplace:
            items = [_to_bytes(x, encoding) for x in obj]
            obj.clear()
            obj.update(items)
            return obj
        return {_to_bytes(x, encoding) for x in obj}
    return _to_bytes(obj, encoding)


def _to_bytes(obj, encoding):
    if obj is None or isinstance(obj, bytes):
        return obj
    if isinstance(obj, str):
        return obj.encode(encoding)
    if isinstance(obj, bytearray):
        return bytes(obj)
    return str(obj).encode(encoding)


def round(x, d=0):
    """Python-2-style round-half-away-from-zero (python3 rounds half to
    even); the reference keeps the py2 semantics."""
    if math.isinf(x) or math.isnan(x):
        return x
    p = 10 ** d
    if x >= 0:
        return float(math.floor((x * p) + 0.5)) / p
    return float(math.ceil((x * p) - 0.5)) / p


def floor_division(x, y):
    """Explicit integer floor division."""
    return x // y


def get_exception_message(exc):
    """The message string of an exception instance."""
    if exc is None:
        raise ValueError("exc should not be None")
    return str(exc)
