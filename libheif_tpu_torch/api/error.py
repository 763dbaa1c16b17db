"""Error API (ref: libheif/api/libheif/heif_error.h); counterpart of
libheif_tpu/api/error.py.

The C API returns `heif_error{code, subcode, message}` by value from
every call; this package raises `HeifError` instead. This module gives
the struct view for callers porting reference code: `heif_error` is a
frozen dataclass, `error_ok` the success value, and `catching()` a
context manager converting raised `HeifError`s into returned structs.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

from ..core.error import ErrorCode, SubError, HeifError

heif_error_code = ErrorCode
heif_suberror_code = SubError


@dataclass(frozen=True)
class heif_error:
    """(ref: heif_error.h:1 `struct heif_error`)."""

    code: ErrorCode = ErrorCode.Ok
    subcode: SubError = SubError.Unspecified
    message: str = "Success"

    @property
    def ok(self) -> bool:
        return self.code == ErrorCode.Ok


error_ok = heif_error()


def error_from_exception(e: HeifError) -> heif_error:
    return heif_error(code=e.code, subcode=e.subcode, message=str(e))


class _Catcher:
    def __init__(self):
        self.error = error_ok

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None and issubclass(et, HeifError):
            self.error = error_from_exception(ev)
            return True
        return False


def catching() -> _Catcher:
    """`with catching() as c: ...; c.error` — C-style error capture."""
    return _Catcher()


def heif_error_success() -> heif_error:
    return error_ok
