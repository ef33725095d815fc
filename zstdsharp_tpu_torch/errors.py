"""Error codes and exception types (the port's copy of
zstdsharp_tpu/errors.py).

Mirrors the reference's error discipline (ZSTD_ErrorCode.cs,
ErrorPrivate.cs:10-33): the C library encodes errors as negative size_t
values; here every fallible boundary raises :class:`ZstdError` carrying the
equivalent :class:`ZstdErrorCode` so callers can match on the same taxonomy.
"""

from __future__ import annotations

import enum


class ZstdErrorCode(enum.IntEnum):
    """Error codes, value-compatible with zstd's ZSTD_ErrorCode."""

    no_error = 0
    generic = 1
    prefix_unknown = 10
    version_unsupported = 12
    frameParameter_unsupported = 14
    frameParameter_windowTooLarge = 16
    corruption_detected = 20
    checksum_wrong = 22
    literals_headerWrong = 24
    dictionary_corrupted = 30
    dictionary_wrong = 32
    dictionaryCreation_failed = 34
    parameter_unsupported = 40
    parameter_combination_unsupported = 41
    parameter_outOfBound = 42
    tableLog_tooLarge = 44
    maxSymbolValue_tooLarge = 46
    maxSymbolValue_tooSmall = 48
    stabilityCondition_notRespected = 50
    stage_wrong = 60
    init_missing = 62
    memory_allocation = 64
    workSpace_tooSmall = 66
    dstSize_tooSmall = 70
    srcSize_wrong = 72
    dstBuffer_null = 74
    noForwardProgress_destFull = 80
    noForwardProgress_inputEmpty = 82


class ZstdError(Exception):
    """Raised for any zstd format or usage error."""

    def __init__(self, code: ZstdErrorCode, message: str = ""):
        self.code = ZstdErrorCode(code)
        super().__init__(message or self.code.name)


def check(cond: bool, code: ZstdErrorCode, message: str = "") -> None:
    if not cond:
        raise ZstdError(code, message)
