"""Device resolution (counterpart of the reference's ``core/device.py``).

The port's entry points run on the card: ``device=None`` means ``cuda``.
A machine without a card raises here, naming the way out
(``device="cpu"``), so there is no silent CPU path.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .errors import UnavailableError

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``.

    Raises :class:`UnavailableError` when a CUDA device is asked for (or
    defaulted to) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise UnavailableError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device=\"cpu\" to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise UnavailableError(
            "unsupported device %r: the port runs on 'cuda' or, when asked, "
            "on 'cpu'" % (str(dev),))
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same place (``cuda`` == ``cuda:0``
    when 0 is the current card)."""
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)
