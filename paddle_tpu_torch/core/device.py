"""Device resolution and the place API (counterpart of the reference's
``core/device.py``).

The port's entry points run on the card: ``device=None`` means ``cuda``,
unless :func:`set_device` named another place.  A machine without a card
raises here, naming the way out (``device="cpu"``), so there is no silent
CPU path.

A :class:`Place` is a kind (``"cpu"`` or ``"gpu"``) and an index, as the
reference's; ``CUDAPlace(i)`` is ``gpu:i``, ``CUDAPinnedPlace`` the host.
The reference resolves ``TPUPlace``/``XPUPlace``/``NPUPlace`` to whatever
accelerator is present; here they raise :class:`UnavailableError`, so no
device is picked silently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .errors import InvalidArgumentError, UnavailableError

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "NPUPlace", "set_device", "get_device",
           "current_place", "device_count", "synchronize",
           "is_compiled_with_cuda", "is_compiled_with_tpu", "resolve_device",
           "same_device"]


@dataclasses.dataclass(frozen=True)
class Place:
    """A device: ``kind`` (``"cpu"`` or ``"gpu"``) and an index."""

    kind: str
    index: int = 0

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.index) if self.kind == "gpu" \
            else torch.device("cpu")

    def __repr__(self) -> str:  # paddle prints e.g. GPUPlace(0)
        return f"{self.kind.upper()}Place({self.index})"


def CPUPlace(index: int = 0) -> Place:
    return Place("cpu", index)


def CUDAPlace(index: int = 0) -> Place:
    return Place("gpu", index)


def CUDAPinnedPlace(index: int = 0) -> Place:
    """Pinned host memory is host memory: the CPU place."""
    return Place("cpu", index)


def _no_such_place(kind: str, index: int):
    raise UnavailableError(
        "%s(%d): the port runs on CUDA cards and the CPU only; use "
        "CUDAPlace or CPUPlace" % (kind, index))


def TPUPlace(index: int = 0) -> Place:
    _no_such_place("TPUPlace", index)


def XPUPlace(index: int = 0) -> Place:
    _no_such_place("XPUPlace", index)


def NPUPlace(index: int = 0) -> Place:
    _no_such_place("NPUPlace", index)


DeviceLike = Optional[Union[str, torch.device, Place]]

_current_place: Optional[Place] = None


def _parse_place(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place("gpu" if device.type == "cuda" else device.type,
                     device.index or 0)
    kind, _, idx = str(device).partition(":")
    kind = {"cuda": "gpu"}.get(kind, kind)
    if kind in ("tpu", "xpu", "npu"):
        _no_such_place(kind.upper() + "Place", int(idx or 0))
    if kind not in ("cpu", "gpu"):
        raise InvalidArgumentError(
            "unknown device %r: expected 'cpu', 'gpu' or 'gpu:<index>'"
            % (device,))
    return Place(kind, int(idx) if idx else 0)


def set_device(device) -> Place:
    """Make ``device`` (``"cpu"``, ``"gpu"``, ``"gpu:1"``, ``"cuda:0"`` or a
    :class:`Place`) the place ``device=None`` resolves to in every entry
    point of the port.  A card that is not there raises."""
    global _current_place
    place = _parse_place(device)
    if place.kind == "gpu":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if place.index >= n:
            raise UnavailableError(
                "set_device(%r): %d CUDA device(s) visible" % (device, n))
        torch.cuda.set_device(place.index)
    _current_place = place
    return place


def current_place() -> Place:
    """The place ``device=None`` resolves to: the one :func:`set_device`
    named, else the current card, else (no card) the CPU."""
    if _current_place is not None:
        return _current_place
    if torch.cuda.is_available():
        return Place("gpu", torch.cuda.current_device())
    return Place("cpu", 0)


def get_device() -> str:
    """The current place as a string, e.g. ``"gpu:0"`` or ``"cpu:0"``."""
    place = current_place()
    return f"{place.kind}:{place.index}"


def device_count(kind: Optional[str] = None) -> int:
    """Visible devices of ``kind`` (``"gpu"`` by default; ``"cpu"`` is 1)."""
    if kind == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def synchronize(device=None) -> None:
    """Block the host until the card's queued work is done (nothing to wait
    for without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(None if device is None
                               else _parse_place(device).index)


def is_compiled_with_cuda() -> bool:
    """Whether torch was built with CUDA."""
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the place
    :func:`set_device` named, else ``cuda``.

    Raises :class:`UnavailableError` when a CUDA device is asked for (or
    defaulted to) and ``torch.cuda.is_available()`` is false."""
    if device is None:
        device = "cuda" if _current_place is None \
            else _current_place.torch_device()
    elif isinstance(device, Place):
        device = device.torch_device()
    elif isinstance(device, str) and device.split(":")[0] == "gpu":
        device = "cuda" + device[3:]
    dev = torch.device(device)
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
