"""Streaming reader protocol: the heif_reader v2 equivalent.

Counterpart of libheif_tpu/io/reader.py (reference: heif_reader struct
api/libheif/heif_context.h:164-231 — get_position/read/seek/
wait_for_file_size plus the v2 streaming functions request_range/
preload_range_hint/release_file_range; StreamReader classes
bitstream.h:39-153).

The purpose is on-demand access: a gigapixel tiled file served over a
network is never fetched whole — the container layer requests only the
byte ranges of the boxes it parses and of the items and tiles it
decodes.

Pythonic surface: one method pair instead of C function pointers.

- ``request_range(start, end) -> GrowStatus`` — blocking availability
  guarantee for ``[start, end)``; returns SIZE_BEYOND_EOF when the
  range exceeds the (current) file size.
- ``read(start, size) -> bytes`` — must follow a successful
  request_range; short reads raise.
- ``wait_for_file_size(target) -> GrowStatus`` — for growing files.
- ``preload_range_hint`` / ``release_file_range`` — optional cache
  hints, non-blocking, default no-ops.
"""

from __future__ import annotations

import enum
import io
import os
from typing import Callable, Optional

from ..core.error import ErrorCode, HeifError


class GrowStatus(enum.Enum):
    """(ref: heif_reader_grow_status, heif_context.h)."""
    SIZE_REACHED = 0
    TIMEOUT = 1
    SIZE_BEYOND_EOF = 2
    ERROR = 3


class StreamReader:
    """Abstract reader (ref: StreamReader bitstream.h:39)."""

    def file_size(self) -> Optional[int]:
        """Total size if known, else None (still-growing files)."""
        return None

    def wait_for_file_size(self, target: int) -> GrowStatus:
        size = self.file_size()
        if size is None:
            return GrowStatus.TIMEOUT
        return GrowStatus.SIZE_REACHED if target <= size \
            else GrowStatus.SIZE_BEYOND_EOF

    def request_range(self, start: int, end: int) -> GrowStatus:
        return self.wait_for_file_size(end)

    def preload_range_hint(self, start: int, end: int) -> None:
        pass

    def release_file_range(self, start: int, end: int) -> None:
        pass

    def read(self, start: int, size: int) -> bytes:
        raise NotImplementedError


class MemoryReader(StreamReader):
    """Reader over an in-memory buffer
    (ref: StreamReader_memory bitstream.h:91)."""

    def __init__(self, data: bytes):
        self._data = memoryview(data)

    def file_size(self) -> int:
        return len(self._data)

    def read(self, start: int, size: int) -> bytes:
        if start + size > len(self._data):
            raise HeifError.eof(
                f"read [{start}+{size}] beyond buffer end")
        return bytes(self._data[start:start + size])


class FileReader(StreamReader):
    """Reader over a local file, seeking on demand
    (ref: StreamReader_istream bitstream.h:39)."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, (str, os.PathLike)):
            if not os.path.exists(path_or_file):
                raise HeifError(ErrorCode.Input_does_not_exist,
                                message=str(path_or_file))
            self._f = open(path_or_file, "rb")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self._f.seek(0, io.SEEK_END)
        self._size = self._f.tell()

    def file_size(self) -> int:
        return self._size

    def read(self, start: int, size: int) -> bytes:
        self._f.seek(start)
        data = self._f.read(size)
        if len(data) != size:
            raise HeifError.eof(f"short read [{start}+{size}]")
        return data

    def close(self) -> None:
        if self._owns:
            self._f.close()


class CallbackReader(StreamReader):
    """Adapter for user-supplied callables, mirroring the heif_reader
    C struct field-for-field (ref: heif_context.h:164-231)."""

    def __init__(self,
                 read: Callable[[int, int], bytes],
                 file_size: Optional[Callable[[], Optional[int]]] = None,
                 wait_for_file_size: Optional[
                     Callable[[int], GrowStatus]] = None,
                 request_range: Optional[
                     Callable[[int, int], GrowStatus]] = None,
                 preload_range_hint: Optional[
                     Callable[[int, int], None]] = None,
                 release_file_range: Optional[
                     Callable[[int, int], None]] = None):
        self._read = read
        self._file_size = file_size
        self._wait = wait_for_file_size
        self._request = request_range
        self._preload = preload_range_hint
        self._release = release_file_range

    def file_size(self) -> Optional[int]:
        return self._file_size() if self._file_size else None

    def wait_for_file_size(self, target: int) -> GrowStatus:
        if self._wait:
            return self._wait(target)
        return super().wait_for_file_size(target)

    def request_range(self, start: int, end: int) -> GrowStatus:
        if self._request:
            return self._request(start, end)
        return super().request_range(start, end)

    def preload_range_hint(self, start: int, end: int) -> None:
        if self._preload:
            self._preload(start, end)

    def release_file_range(self, start: int, end: int) -> None:
        if self._release:
            self._release(start, end)

    def read(self, start: int, size: int) -> bytes:
        data = self._read(start, size)
        if len(data) != size:
            raise HeifError.eof(f"reader returned short data "
                                f"[{start}+{size}] -> {len(data)}")
        return data
