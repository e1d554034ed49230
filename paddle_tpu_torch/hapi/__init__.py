"""The high-level API (counterpart of the reference's ``hapi``):
``Model``, its callbacks, ``summary`` and ``flops``."""
from . import callbacks  # noqa: F401
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau,
                        VisualDL)
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401

__all__ = ["Model", "callbacks", "summary", "flops", "Callback",
           "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "VisualDL"]
