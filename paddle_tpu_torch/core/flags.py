"""Global runtime flag registry (counterpart of the reference's
``core/flags.py``): ``define_flag``, ``set_flags``, ``get_flags`` and
``flag``, with ``FLAGS_*`` environment variables parsed when a flag is
defined, as the reference parses them.

The reference's ten flags are defined here with its names, defaults and
help.  Where their readers are ported they act as the reference's do:
``FLAGS_check_nan_inf`` (the op shim's output scan,
``framework/dispatch.py``), ``FLAGS_seq_block_size``
(``ops/flash_attention.py``), ``FLAGS_log_level`` (``core/errors.py``)
and ``FLAGS_amp_dtype`` (``amp``) and ``FLAGS_benchmark`` (the op shim's
per-op timing, ``profiler``).  ``FLAGS_prefetch_depth``,
``FLAGS_jit_cache``, ``FLAGS_use_donated_buffers``, ``FLAGS_eager_mode``
and ``FLAGS_deterministic`` are defined and round-trip; their readers
(io, the static jit, the sampler) are not ported yet.
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


def get_flags(flags: Iterable[str] | str | None = None) -> Dict[str, Any]:
    """paddle.get_flags: {name: value} of the named flags (one name or a
    list); ``None`` gives every flag."""
    with _lock:
        if flags is None:
            return {k: f.value for k, f in _REGISTRY.items()}
        if isinstance(flags, str):
            flags = [flags]
        return {name: _REGISTRY[name].value for name in flags}


def flag(name: str) -> Any:
    """One flag's value."""
    return _REGISTRY[name].value


define_flag("FLAGS_check_nan_inf", False,
            "scan outputs of each jitted step for nan/inf (debug)")
define_flag("FLAGS_benchmark", False,
            "block on each step for accurate timing")
define_flag("FLAGS_deterministic", True,
            "prefer deterministic XLA reductions")
define_flag("FLAGS_log_level", 0,
            "verbosity for paddle_tpu host-side logging (GLOG_v analog)")
define_flag("FLAGS_use_donated_buffers", True,
            "donate param/opt-state buffers into jitted train steps")
define_flag("FLAGS_prefetch_depth", 2,
            "device prefetch depth for DataLoader double buffering")
define_flag("FLAGS_amp_dtype", "bfloat16",
            "autocast compute dtype (bfloat16|float16)")
define_flag("FLAGS_jit_cache", True,
            "reuse compiled executables across to_static calls")
define_flag("FLAGS_seq_block_size", 512,
            "ring/flash attention block length on the sequence axis")
define_flag("FLAGS_eager_mode", True,
            "ops execute eagerly (dygraph) when not inside jit")
