"""Error model mirroring the reference BROTLIG_ERROR enum
(inc/common/BrotligCommon.h:50-68) as a typed exception hierarchy, plus the
feedback-message kinds (BROTLIG_MESSAGE_TYPE). The port's copy of the
part of brotlig_tpu/format/errors.py it raises: same names, codes and
messages."""
from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    OK = 0
    ABORTED = 1
    MIN_PAGE_SIZE = 2
    MAX_PAGE_SIZE = 3
    MAX_NUM_PAGES = 4
    PRECON_MIN_TEX_WIDTH = 5
    PRECON_MAX_TEX_WIDTH = 6
    PRECON_MIN_TEX_HEIGHT = 7
    PRECON_MAX_TEX_HEIGHT = 8
    PRECON_MIN_TEX_PITCH = 9
    PRECON_MAX_TEX_PITCH = 10
    PRECON_MIN_TEX_MIPLEVELS = 11
    PRECON_MAX_TEX_MIPLEVELS = 12
    PRECON_INCORRECT_FORMAT = 13
    CORRUPT_STREAM = 14
    INCORRECT_STREAM_FORMAT = 15
    GENERIC = 16


class MessageType(enum.IntEnum):
    PROGRESS = 0
    WARNING = 1


class BrotligError(ValueError):
    code = ErrorCode.GENERIC


class Aborted(BrotligError):
    """Feedback callback requested an abort."""
    code = ErrorCode.ABORTED


class TooManyPages(BrotligError):
    code = ErrorCode.MAX_NUM_PAGES


class CorruptStream(BrotligError):
    code = ErrorCode.CORRUPT_STREAM


class IncorrectStreamFormat(BrotligError):
    code = ErrorCode.INCORRECT_STREAM_FORMAT
