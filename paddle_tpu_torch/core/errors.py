"""Typed error taxonomy (a copy of the reference's ``core/errors.py``).

The port keeps its own copy rather than importing the reference: importing
anything under ``paddle_tpu`` runs that package's ``__init__``, which
imports JAX.  The class names and error codes are the reference's, so a
caller that catches one package's errors reads the other's the same way.
With ``FLAGS_log_level`` at 1 or more a message carries the Python frames
that raised it, as the reference's.
"""
from __future__ import annotations

import traceback
from typing import Any, NoReturn, Optional


class EnforceNotMet(RuntimeError):
    """Base error; carries an error-code name like the reference proto."""

    code = "LEGACY"

    def __init__(self, message: str, hint: Optional[str] = None):
        self.raw_message = message
        self.hint = hint
        full = f"[{self.code}] {message}"
        if hint:
            full += f"\n  [Hint: {hint}]"
        from .flags import _REGISTRY
        level = _REGISTRY.get("FLAGS_log_level")
        if level is not None and level.value >= 1:
            full += "\n  [Python call stack]\n" + current_python_callstack()
        super().__init__(full)


class InvalidArgumentError(EnforceNotMet):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


def enforce(cond: Any, message: str, exc: type = InvalidArgumentError,
            hint: Optional[str] = None) -> None:
    """PADDLE_ENFORCE: raise ``exc(message, hint=hint)`` when ``cond`` is
    falsy.  A host-side check: never pass it a device tensor, whose truth
    value would read the card back."""
    if not cond:
        raise exc(message, hint=hint)


def enforce_eq(a: Any, b: Any, what: str = "value") -> None:
    if a != b:
        raise InvalidArgumentError(f"expected {what} == {b!r}, got {a!r}")


def enforce_shape(x: Any, expected: tuple, what: str = "tensor") -> None:
    """``x.shape`` against ``expected``; -1 or None matches any size."""
    shape = tuple(x.shape)
    if len(shape) != len(expected) or any(
            e not in (-1, None, s) for s, e in zip(shape, expected)):
        raise InvalidArgumentError(
            f"{what} shape mismatch: expected {expected}, got {shape}")


def raise_unimplemented(feature: str) -> NoReturn:
    raise UnimplementedError(
        f"{feature} is not implemented in paddle_tpu_torch yet",
        hint="see ROADMAP.md for what is still to port")


def current_python_callstack(limit: int = 8) -> str:
    """The Python frames that led here (the reference's op-call-stack
    attribution), this function's own left out."""
    return "".join(traceback.format_stack(limit=limit)[:-1])
