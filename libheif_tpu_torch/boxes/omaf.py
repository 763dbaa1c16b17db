"""OMAF 360° projection boxes (ref: libheif/omaf_boxes.{h,cc},
Box_prfr omaf_boxes.h:33); counterpart of libheif_tpu/boxes/omaf.py.
"""

from __future__ import annotations

from typing import List

from ..core.bitstream import ByteReader, ByteWriter
from ..core.limits import SecurityLimits
from .box import FullBox, register_box

# projection types (ref: heif_omaf.h heif_projection_format)
PROJECTION_EQUIRECTANGULAR = 0
PROJECTION_CUBEMAP = 1


@register_box("prfr")
class Box_prfr(FullBox):
    """Projection format box (ref: omaf_boxes.h:33 Box_prfr)."""

    def __init__(self, projection_type: int = PROJECTION_EQUIRECTANGULAR):
        super().__init__()
        self.projection_type = projection_type

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.parse_full_header(r)
        self.projection_type = r.read8() & 0x1F

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write8(self.projection_type & 0x1F)

    def dump_fields(self) -> List[str]:
        name = {0: "equirectangular", 1: "cubemap"}.get(
            self.projection_type, f"{self.projection_type}")
        return [f"projection: {name}"]
