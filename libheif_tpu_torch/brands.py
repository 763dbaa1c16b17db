"""Brand computation and inspection.

Counterpart of libheif_tpu/brands.py, the whole module (``compute_brands``
:36, ``brand_for_item_type`` and the read helpers; reference:
libheif/brands.cc, api/libheif/heif_brands.h: heif_read_main_brand,
heif_list_compatible_brands, heif_has_compatible_filetype).  Brands are
derived from content: the item types present, the primary item, and any
sequence tracks.  ``HeifContext.write`` sets a new file's ftyp from them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

# major brand per primary coded item type (ref: brands.cc
# encoder-format → brand mapping used at write time)
_ITEM_BRAND = {
    "hvc1": "heic", "hev1": "heix",
    "av01": "avif",
    "vvc1": "vvic",
    "avc1": "avci",
    "jpeg": "jpeg",
    "j2k1": "j2ki",
    "unci": "mif2",
    "mski": "mif1",
    "grid": "mif1", "iovl": "mif1", "iden": "mif1", "tili": "mif1",
}
# sequence brand per visual-track sample-entry type
_TRACK_BRAND = {"hvc1": "hevc", "hev1": "hevc", "av01": "avis",
                "avc1": "avcs", "vvc1": "vvis"}


def brand_for_item_type(item_type: str) -> str:
    return _ITEM_BRAND.get(item_type, "mif1")


def compute_brands(item_types: List[str], primary_type: Optional[str],
                   track_entry_types: List[str] = ()) -> Tuple[str, List[str]]:
    """(major, compatible) from content (ref: brands.cc write path).

    Rules: still items ⇒ 'mif1' structural brand; MIAF-eligible coded
    primaries add 'miaf'; sequences add 'msf1' plus codec sequence
    brands; a sequence-only file promotes the sequence brand to major.
    """
    compat: List[str] = []

    def add(b: str) -> None:
        if b and b not in compat:
            compat.append(b)

    major = None
    if primary_type is not None:
        major = brand_for_item_type(primary_type)
    elif item_types:
        major = brand_for_item_type(item_types[0])

    if item_types:
        add("mif1")
    for t in item_types:
        add(brand_for_item_type(t))
    if major in ("heic", "avif"):
        add("miaf")
    if major == "heic":
        # single-layer HEVC Main profile images (MIAF §A.3)
        add("MiHB")
    if major == "avif":
        add("MA1B")

    if track_entry_types:
        add("msf1")
        for t in track_entry_types:
            add(_TRACK_BRAND.get(t, ""))
        if major is None:
            # pure sequence file
            for t in track_entry_types:
                if t in _TRACK_BRAND:
                    major = "msf1" if _TRACK_BRAND[t] == "hevc" else \
                        _TRACK_BRAND[t]
                    break
            major = major or "msf1"

    major = major or "mif1"
    add(major)
    return major, compat


# ------------------------------------------------------------- inspection

def read_main_brand(data: bytes) -> str:
    """Major brand from the first bytes of a file
    (ref: heif_read_main_brand — needs ≥12 bytes)."""
    if len(data) < 12 or data[4:8] != b"ftyp":
        return "    "
    return data[8:12].decode("latin-1")


def read_minor_version(data: bytes) -> int:
    if len(data) < 16 or data[4:8] != b"ftyp":
        return 0
    return int.from_bytes(data[12:16], "big")


def list_compatible_brands(data: bytes) -> List[str]:
    """(ref: heif_list_compatible_brands)."""
    if len(data) < 16 or data[4:8] != b"ftyp":
        return []
    size = int.from_bytes(data[0:4], "big")
    if size < 16 or size > len(data):
        size = min(len(data), size if size >= 16 else len(data))
    out = []
    for off in range(16, size - 3, 4):
        out.append(data[off:off + 4].decode("latin-1"))
    return out


def has_compatible_filetype(data: bytes) -> bool:
    """Is this a HEIF-family file we can handle
    (ref: heif_has_compatible_filetype)."""
    known = {"heic", "heix", "heim", "heis", "hevc", "hevx", "mif1",
             "mif2", "msf1", "avif", "avis", "vvic", "vvis", "avci",
             "avcs", "jpeg", "j2ki", "miaf", "1pic"}
    main = read_main_brand(data)
    if main in known:
        return True
    return any(b in known for b in list_compatible_brands(data))
