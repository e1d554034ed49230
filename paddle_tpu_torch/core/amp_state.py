"""Thread-local autocast state, read by the op shim of
``framework/dispatch.py`` (counterpart of the reference's
``core/amp_state.py``).

It lives in ``core`` so the shim can read it without importing the
user-facing ``amp`` package.
"""
from __future__ import annotations

import threading
from typing import Optional, Set

__all__ = ["AmpAttrs", "current", "push", "pop", "amp_enabled"]

_tls = threading.local()


class AmpAttrs:
    __slots__ = ("enabled", "dtype", "white", "black", "level")

    def __init__(self, enabled=False, dtype="bfloat16",
                 white: Optional[Set[str]] = None,
                 black: Optional[Set[str]] = None, level: str = "O1"):
        self.enabled = enabled
        self.dtype = dtype
        self.white = white or set()
        self.black = black or set()
        self.level = level


_DISABLED = AmpAttrs()


def current() -> AmpAttrs:
    return getattr(_tls, "state", _DISABLED)


def push(state: AmpAttrs) -> AmpAttrs:
    """Make ``state`` current on this thread; returns the one it replaced."""
    prev = current()
    _tls.state = state
    return prev


def pop(prev: AmpAttrs) -> None:
    _tls.state = prev


def amp_enabled() -> bool:
    return current().enabled
