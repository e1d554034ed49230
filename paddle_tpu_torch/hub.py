"""``paddle.hub`` namespace: re-exports the hapi hub implementation
(mirrors the reference layout: ``python/paddle/hub.py`` → ``hapi/hub.py``).
"""
from .hapi.hub import help, list, load  # noqa: F401,A004

__all__ = ["list", "help", "load"]
