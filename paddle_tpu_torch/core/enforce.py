"""Structured errors — PADDLE_ENFORCE analog (common/enforce.h, common/errors.cc).

Typed error classes matching the reference's common::errors taxonomy, plus enforce_*
helpers that raise them with op-context attribution.
"""
from __future__ import annotations


class EnforceError(RuntimeError):
    code = "FATAL"

    def __init__(self, msg, op=None):
        if op:
            msg = f"(op: {op}) {msg}"
        super().__init__(f"[{self.code}] {msg}")


class InvalidArgumentError(EnforceError, ValueError):
    code = "InvalidArgument"


class NotFoundError(EnforceError, KeyError):
    code = "NotFound"


class OutOfRangeError(EnforceError, IndexError):
    code = "OutOfRange"


class AlreadyExistsError(EnforceError):
    code = "AlreadyExists"


class PermissionDeniedError(EnforceError):
    code = "PermissionDenied"


class UnimplementedError(EnforceError, NotImplementedError):
    code = "Unimplemented"


class UnavailableError(EnforceError):
    code = "Unavailable"


class PreconditionNotMetError(EnforceError):
    code = "PreconditionNotMet"


class ExecutionTimeoutError(EnforceError):
    code = "ExecutionTimeout"


def enforce(cond, msg="enforce failed", op=None, err=PreconditionNotMetError):
    if not cond:
        raise err(msg, op=op)


def enforce_eq(a, b, msg="", op=None):
    if a != b:
        raise InvalidArgumentError(f"expected {a!r} == {b!r}. {msg}", op=op)


def enforce_gt(a, b, msg="", op=None):
    if not a > b:
        raise InvalidArgumentError(f"expected {a!r} > {b!r}. {msg}", op=op)


def enforce_ge(a, b, msg="", op=None):
    if not a >= b:
        raise InvalidArgumentError(f"expected {a!r} >= {b!r}. {msg}", op=op)


def enforce_not_none(v, name="value", op=None):
    if v is None:
        raise InvalidArgumentError(f"{name} must not be None", op=op)
    return v
