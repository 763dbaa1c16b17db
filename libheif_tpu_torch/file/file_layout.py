"""Progressive top-level parse over a streaming reader.

Counterpart of libheif_tpu/file/file_layout.py (reference:
libheif/file_layout.{h,cc} — FileLayout::read file_layout.cc:38).
Top-level box headers are fetched 8 bytes at a time (16 for a large
size); the structural boxes of a still (ftyp/meta/mini) are
and of a sequence (moov) are range-requested and parsed in full, while
mdat payloads are never fetched — only their [offset, size) extents are
recorded so item and sample reads later request exactly the byte ranges
they need.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..core.bitstream import ByteReader
from ..core.error import ErrorCode, HeifError, SubError
from ..core.limits import SecurityLimits
from ..boxes.box import Box, read_box
from ..io.reader import GrowStatus, StreamReader

# Boxes parsed eagerly during layout read; everything else (mdat, free,
# unknown top-level boxes) is recorded as a lazy extent.
_EAGER_TOP_LEVEL = {"ftyp", "meta", "mini", "moov"}


@dataclass
class LazyBoxExtent:
    """A top-level box whose payload stays unread (typically mdat)."""
    box_type: str
    header_size: int
    start: int          # absolute offset of the box header
    size: int           # full box size incl. header

    @property
    def payload_start(self) -> int:
        return self.start + self.header_size

    @property
    def payload_size(self) -> int:
        return self.size - self.header_size


class FileLayout:
    """Progressive reader-backed top-level structure
    (ref: FileLayout file_layout.h:35)."""

    def __init__(self):
        self.boxes: List[Box] = []
        self.lazy_extents: List[LazyBoxExtent] = []
        self.reader: Optional[StreamReader] = None

    def read(self, reader: StreamReader,
             limits: Optional[SecurityLimits] = None) -> None:
        """(ref: FileLayout::read file_layout.cc:38)."""
        limits = limits or SecurityLimits()
        self.reader = reader
        pos = 0

        if reader.request_range(0, 8) != GrowStatus.SIZE_REACHED:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_ftyp_box,
                            "file too small")

        while True:
            status = reader.request_range(pos, pos + 8)
            if status != GrowStatus.SIZE_REACHED:
                break
            hdr8 = reader.read(pos, 8)
            size = int.from_bytes(hdr8[:4], "big")
            btype = hdr8[4:8].decode("latin-1")
            header_size = 8
            if size == 1:
                if reader.request_range(pos, pos + 16) != \
                        GrowStatus.SIZE_REACHED:
                    raise HeifError.eof("truncated largesize box header")
                size = int.from_bytes(reader.read(pos + 8, 8), "big")
                header_size = 16
            elif size == 0:
                # box extends to EOF
                total = reader.file_size()
                if total is None:
                    raise HeifError.invalid_input(
                        SubError.Invalid_box_size,
                        "size-0 box on a reader with unknown file size")
                size = total - pos
            if size < header_size:
                raise HeifError.invalid_input(
                    SubError.Invalid_box_size,
                    f"box '{btype}' size {size} smaller than header")

            if btype in _EAGER_TOP_LEVEL:
                if reader.request_range(pos, pos + size) != \
                        GrowStatus.SIZE_REACHED:
                    raise HeifError.eof(
                        f"truncated top-level '{btype}' box")
                raw = reader.read(pos, size)
                box = read_box(ByteReader(raw), limits, 0)
                self.boxes.append(box)
            else:
                self.lazy_extents.append(
                    LazyBoxExtent(btype, header_size, pos, size))
            pos += size

    def get_box(self, fourcc: str) -> Optional[Box]:
        for b in self.boxes:
            if b.box_type == fourcc:
                return b
        return None
