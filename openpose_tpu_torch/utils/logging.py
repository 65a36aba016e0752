"""Leveled logging + provenance-carrying errors.

Mirrors errorAndLog (include/openpose/utilities/errorAndLog.hpp:80-128):
`op_log(message, priority)` filtered by a global threshold
(= --logging_level, 0 logs everything), and `OpError` carrying
file/function provenance like op::error's decorated rethrow.
"""

from __future__ import annotations

import enum
import inspect
import sys
from typing import Optional, TextIO


class Priority(enum.IntEnum):
    NONE = 0
    LOW = 1
    NORMAL = 2
    HIGH = 3
    MAX = 4
    NO_OUTPUT = 5


_threshold = Priority.HIGH
_stream: TextIO = sys.stderr


def set_priority_threshold(priority: Priority) -> None:
    global _threshold
    _threshold = Priority(priority)


def op_log(message: str, priority: Priority = Priority.MAX) -> None:
    if priority >= _threshold:
        _stream.write(f"{message}\n")


class OpError(RuntimeError):
    """Error with call-site provenance (op::error semantics)."""

    def __init__(self, message: str):
        frame = inspect.currentframe()
        caller = frame.f_back if frame is not None else None
        if caller is not None:
            info = inspect.getframeinfo(caller)
            message = (f"{message}\nComing from "
                       f"{info.function}():{info.filename}:{info.lineno}")
        super().__init__(message)


def op_error(message: str) -> None:
    op_log(f"Error: {message}", Priority.MAX)
    raise OpError(message)
