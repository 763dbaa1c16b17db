"""Encoding options, the write side's value type.

Counterpart of libheif_tpu/option_types.py (``EncodingOptions`` :25-38,
ref: heif_encoding_options v8, heif_encoding.h:281-332), with the same
fields and defaults.  The read side's option types live in
``items/item.py`` (``DecodingOptions``, ``ImageTiling``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class EncodingOptions:
    """(ref: heif_encoding_options v8, heif_encoding.h:281-332)."""

    save_alpha_channel: bool = True
    image_orientation: int = 1           # EXIF orientation 1..8
    quality: int = 50
    lossless: bool = False
    output_nclx: Optional[object] = None  # NclxProfile
    macOS_compatibility_workaround_no_nclx_profile: bool = False
    save_two_colr_boxes_when_ICC_and_nclx_available: bool = False
    # unci-specific
    tile_cols: int = 1
    tile_rows: int = 1
    compression: Optional[str] = None     # 'zlib' | 'defl' | 'brot'
