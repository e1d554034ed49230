"""Global runtime flag registry (counterpart of the reference's
``core/flags.py``): ``define_flag``, ``set_flags``, ``get_flags`` and
``flag``, with ``FLAGS_*`` environment variables parsed when a flag is
defined, as the reference parses them.

Only ``FLAGS_amp_dtype``, the one flag ``amp`` reads, is defined here;
the reference's other flags come with the code that reads them.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_lock = threading.Lock()


class _Flag:
    __slots__ = ("name", "value", "default", "help")

    def __init__(self, name: str, default: Any, help: str):
        self.name = name
        self.default = default
        self.value = default
        self.help = help


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Register ``name`` with its default; a ``name`` environment variable
    overrides the default, parsed after the default's type.  (The
    reference's ``on_set`` callback has no caller here and is left out.)"""
    with _lock:
        if name in _REGISTRY:
            raise KeyError(f"flag {name} already defined")
        _REGISTRY[name] = _Flag(name, default, help)
    env = os.environ.get(name)
    if env is not None:
        set_flags({name: _parse(env, default)})


def _parse(text: str, default: Any) -> Any:
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    return text


def set_flags(flags: Dict[str, Any]) -> None:
    """paddle.set_flags: set each named flag; an unknown name raises
    ``KeyError`` naming the defined ones."""
    with _lock:
        for name, value in flags.items():
            f = _REGISTRY.get(name)
            if f is None:
                raise KeyError(
                    f"unknown flag {name}; defined: {sorted(_REGISTRY)}")
            f.value = value


def get_flags(flags: Iterable[str] | str) -> Dict[str, Any]:
    """paddle.get_flags: {name: value} of the named flags (one name or a
    list).  (The reference's ``None`` form, every flag, has no caller
    here and is left out.)"""
    with _lock:
        if isinstance(flags, str):
            flags = [flags]
        return {name: _REGISTRY[name].value for name in flags}


def flag(name: str) -> Any:
    """One flag's value."""
    return _REGISTRY[name].value


define_flag("FLAGS_amp_dtype", "bfloat16",
            "autocast compute dtype (bfloat16|float16)")
