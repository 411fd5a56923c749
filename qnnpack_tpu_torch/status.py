"""Status codes and error types: a port of qnnpack_tpu/status.py.

Mirrors QNNPACK's explicit-status philosophy (`enum qnnp_status`,
include/qnnpack.h:24-32): every rejected parameter explains itself.  In
Python the idiomatic surface is an exception carrying the status code; the
C-compatible enum values are preserved for parity.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """qnnp_status equivalents (include/qnnpack.h:24-32)."""

    SUCCESS = 0
    UNINITIALIZED = 1
    INVALID_PARAMETER = 2
    UNSUPPORTED_PARAMETER = 3
    UNSUPPORTED_HARDWARE = 4
    OUT_OF_MEMORY = 5


class QnnpackError(Exception):
    """Base error; carries a Status code."""

    status = Status.INVALID_PARAMETER

    def __init__(self, message: str, status: Status | None = None):
        super().__init__(message)
        if status is not None:
            self.status = status


class InvalidParameterError(QnnpackError):
    status = Status.INVALID_PARAMETER


class UnsupportedParameterError(QnnpackError):
    status = Status.UNSUPPORTED_PARAMETER


class UninitializedError(QnnpackError):
    status = Status.UNINITIALIZED
