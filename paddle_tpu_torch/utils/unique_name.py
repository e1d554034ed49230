"""Process-wide unique names (counterpart of the reference's
``utils/unique_name.py``): ``generate(key)`` gives ``key_0``,
``key_1``, ... under the active generator, which ``guard``/``switch``
replace.

``parameter_name()`` is the default name of a parameter, ``param_<n>``
from a counter of its own, as the reference's ``Parameter`` names itself
(``framework/tensor.py``) when no ``ParamAttr(name=)`` is given.  The
port keeps it in ``p.param_name``: ``torch.Tensor.name`` is torch's.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

__all__ = ["generate", "guard", "switch", "parameter_name"]

_lock = threading.Lock()
_param_ids = itertools.count()


class _Generator:
    def __init__(self):
        self.ids = {}

    def __call__(self, key: str) -> str:
        with _lock:
            n = self.ids.get(key, 0)
            self.ids[key] = n + 1
        return "%s_%d" % (key, n)


_generator = _Generator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator=None):
    """Swap the active generator, returning the previous one."""
    global _generator
    old = _generator
    _generator = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)


def parameter_name() -> str:
    """The next default parameter name, ``param_<n>``."""
    return "param_%d" % next(_param_ids)
