"""Region annotation items (rgan) — spec ISO 23008-12 §6.10.

Counterpart of libheif_tpu/items/region_item.py (reference:
libheif/region.{h,cc} RegionItem region.h:33, geometry classes
region.h:83-186), with ``RegionItem.serialize`` (JAX :91) for the
writer (``HeifContext.add_region_item``).  The rgan payload is a versioned
binary blob (not ISOBMFF boxes): reference space size + a list of
geometries.  Region items attach to images via a 'cdsc' item reference;
a referenced mask geometry names its mask item through a 'mask'
reference (``HeifContext.get_region_items``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, SubError


@dataclass
class RegionGeometry:
    kind: str = "point"            # point|rect|ellipse|polygon|polyline|
                                   # referenced_mask|inline_mask
    x: int = 0
    y: int = 0
    width: int = 0                 # rect / mask
    height: int = 0
    radius_x: int = 0              # ellipse
    radius_y: int = 0
    points: List[Tuple[int, int]] = field(default_factory=list)
    mask_item_id: int = 0          # referenced mask
    mask_data: bytes = b""         # inline mask


_GEOMETRY_IDS = {0: "point", 1: "rect", 2: "ellipse", 3: "polygon",
                 4: "referenced_mask", 5: "inline_mask", 6: "polyline"}
_GEOMETRY_CODES = {v: k for k, v in _GEOMETRY_IDS.items()}


class RegionItem:
    """One rgan item: reference space + geometries (region.h:33)."""

    def __init__(self, item_id: int = 0, reference_width: int = 0,
                 reference_height: int = 0):
        self.item_id = item_id
        self.reference_width = reference_width
        self.reference_height = reference_height
        self.regions: List[RegionGeometry] = []

    # ----------------------------------------------------------- parsing

    @staticmethod
    def parse(item_id: int, data: bytes) -> "RegionItem":
        r = ByteReader(data)
        version = r.read8()
        if version != 0:
            raise HeifError.unsupported(SubError.Unsupported_data_version,
                                        f"rgan version {version}")
        flags = r.read8()
        wide = bool(flags & 1)
        rd = (lambda: r.read32()) if wide else (lambda: r.read16())
        rds = (lambda: r.read32s()) if wide else (lambda: r.read16s())
        out = RegionItem(item_id)
        out.reference_width = rd()
        out.reference_height = rd()
        count = r.read8()
        for _ in range(count):
            g = RegionGeometry()
            kind = r.read8()
            g.kind = _GEOMETRY_IDS.get(kind, f"unknown{kind}")
            if kind == 0:
                g.x, g.y = rds(), rds()
            elif kind == 1:
                g.x, g.y, g.width, g.height = rds(), rds(), rd(), rd()
            elif kind == 2:
                g.x, g.y, g.radius_x, g.radius_y = rds(), rds(), rd(), rd()
            elif kind in (3, 6):
                n = rd()
                g.points = [(rds(), rds()) for _ in range(n)]
            elif kind == 4:
                g.x, g.y, g.width, g.height = rds(), rds(), rd(), rd()
                # mask item comes via an item reference ('mask')
            elif kind == 5:
                g.x, g.y, g.width, g.height = rds(), rds(), rd(), rd()
                g.mask_data = r.read_remaining()
            else:
                break
            out.regions.append(g)
        return out

    # --------------------------------------------------------- transforms

    def transform_to_image(self, g: RegionGeometry, image_width: int,
                           image_height: int) -> RegionGeometry:
        """Scale a geometry from reference space to image space
        (ref: region.h:188 coordinate transform)."""
        if self.reference_width == 0 or self.reference_height == 0:
            return g
        sx = image_width / self.reference_width
        sy = image_height / self.reference_height
        out = RegionGeometry(kind=g.kind,
                             x=round(g.x * sx), y=round(g.y * sy),
                             width=round(g.width * sx),
                             height=round(g.height * sy),
                             radius_x=round(g.radius_x * sx),
                             radius_y=round(g.radius_y * sy),
                             points=[(round(px * sx), round(py * sy))
                                     for (px, py) in g.points],
                             mask_item_id=g.mask_item_id,
                             mask_data=g.mask_data)
        return out

    def serialize(self) -> bytes:
        wide = (self.reference_width > 0xFFFF or
                self.reference_height > 0xFFFF or
                any(max(abs(g.x), abs(g.y), g.width, g.height,
                        g.radius_x, g.radius_y) > 0x7FFF
                    for g in self.regions))
        w = ByteWriter()
        w.write8(0)
        w.write8(1 if wide else 0)
        wr = w.write32 if wide else w.write16
        wrs = w.write32s if wide else w.write16s
        wr(self.reference_width)
        wr(self.reference_height)
        w.write8(len(self.regions))
        for g in self.regions:
            code = _GEOMETRY_CODES[g.kind]
            w.write8(code)
            if code == 0:
                wrs(g.x), wrs(g.y)
            elif code == 1:
                wrs(g.x), wrs(g.y), wr(g.width), wr(g.height)
            elif code == 2:
                wrs(g.x), wrs(g.y), wr(g.radius_x), wr(g.radius_y)
            elif code in (3, 6):
                wr(len(g.points))
                for (px, py) in g.points:
                    wrs(px), wrs(py)
            elif code in (4, 5):
                wrs(g.x), wrs(g.y), wr(g.width), wr(g.height)
                if code == 5:
                    w.write_bytes(g.mask_data)
        return w.data()
