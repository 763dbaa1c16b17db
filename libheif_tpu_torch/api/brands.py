"""Brand API (ref: api/libheif/heif_brands.h, 12 fns); counterpart
of libheif_tpu/api/brands.py.

ftyp major/compatible brand inspection and filetype probing over raw
bytes (ref: heif_brands.h → brands.cc).
"""

from __future__ import annotations

from typing import List

from .. import brands as _b
from ..core.fourcc import fourcc, fourcc_to_str


def heif_read_main_brand(data: bytes) -> str:
    """(ref: heif_read_main_brand)."""
    return _b.read_main_brand(data)


def heif_read_minor_version_brand(data: bytes) -> int:
    return _b.read_minor_version(data)


def heif_fourcc_to_brand(fourcc_str: str) -> str:
    return fourcc_str  # brands are fourcc strings in this framework


def heif_brand_to_fourcc(brand: str) -> str:
    return brand


def heif_has_compatible_brand(data: bytes, brand_fourcc: str) -> bool:
    return brand_fourcc in _b.list_compatible_brands(data)


def heif_list_compatible_brands(data: bytes) -> List[str]:
    return _b.list_compatible_brands(data)


def heif_free_list_of_compatible_brands(brands) -> None:
    pass


def heif_get_file_mime_type(data: bytes) -> str:
    """(ref: heif_get_file_mime_type): sniff the container flavor."""
    brand = _b.read_main_brand(data) if len(data) >= 12 else ""
    if brand in ("heic", "heix", "heim", "heis"):
        return "image/heic"
    if brand in ("mif1", "mif2", "mif3", "miaf"):
        return "image/heif"
    if brand in ("hevc", "hevx"):
        return "image/heic-sequence"
    if brand == "avif":
        return "image/avif"
    if brand == "avis":
        return "image/avif-sequence"
    if brand in ("msf1", "msf2"):
        return "image/heif-sequence"
    if brand in ("j2ki", "j2is"):
        return "image/hej2k"
    return ""


def heif_check_filetype(data: bytes) -> str:
    """(ref: heif_check_filetype): 'supported' | 'maybe' | 'no' |
    'insufficient'."""
    if len(data) < 12:
        return "insufficient"
    if data[4:8] != b"ftyp":
        return "no"
    brand = _b.read_main_brand(data)
    known = {"heic", "heix", "heim", "heis", "hevc", "hevx", "mif1",
             "mif2", "mif3", "msf1", "msf2", "miaf", "avif", "avis",
             "j2ki", "j2is", "jpeg", "1pic"}
    if brand in known:
        return "supported"
    if _b.has_compatible_filetype(data):
        return "supported"
    return "maybe"


def heif_check_jpeg_filetype(data: bytes) -> bool:
    return len(data) >= 3 and data[:3] == b"\xff\xd8\xff"


def heif_main_brand(data: bytes) -> str:
    """Deprecated v1 name (ref: heif_main_brand)."""
    return heif_read_main_brand(data)


def heif_has_compatible_filetype(data: bytes) -> bool:
    """(ref: heif_brands.h heif_has_compatible_filetype)."""
    return _b.has_compatible_filetype(data)
