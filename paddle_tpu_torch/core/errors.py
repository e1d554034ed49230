"""Typed error taxonomy (a copy of the reference's ``core/errors.py``).

The port keeps its own copy rather than importing the reference: importing
anything under ``paddle_tpu`` runs that package's ``__init__``, which
imports JAX.  The class names and error codes are the reference's, so a
caller that catches one package's errors reads the other's the same way.
"""
from __future__ import annotations

from typing import Optional


class EnforceNotMet(RuntimeError):
    """Base error; carries an error-code name like the reference proto."""

    code = "LEGACY"

    def __init__(self, message: str, hint: Optional[str] = None):
        self.raw_message = message
        self.hint = hint
        full = f"[{self.code}] {message}"
        if hint:
            full += f"\n  [Hint: {hint}]"
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
