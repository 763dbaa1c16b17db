"""JPEG 2000 boxes (ISO/IEC 15444-1/-16; ref: codecs/jpeg2000_boxes.h).

`j2kH` is the JPEG 2000 header item property (container of cdef/cmap/
pclr/j2kL); `cdef` maps codestream components to channel types,
`cmap` maps components to channels (incl. palette columns), `pclr`
carries palettes, `j2kL` declares discardable layers.

A copy of libheif_tpu/boxes/j2k.py: every box parses and writes the
same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..core.bitstream import ByteReader, ByteWriter
from ..core.limits import SecurityLimits
from .box import Box, FullBox, register_box


@register_box("cdef")
class Box_cdef(Box):
    """Channel definition (ref: jpeg2000_boxes.h:55 Box_cdef)."""

    def __init__(self):
        super().__init__()
        # (channel_index, channel_type, channel_association)
        # type: 0 colour, 1 alpha, 2 premultiplied alpha
        self.channels: List[Tuple[int, int, int]] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        n = r.read16()
        limits.check_children_count(n, "cdef")
        self.channels = [(r.read16(), r.read16(), r.read16())
                         for _ in range(n)]

    def write_payload(self, w: ByteWriter) -> None:
        w.write16(len(self.channels))
        for (ci, ty, asoc) in self.channels:
            w.write16(ci)
            w.write16(ty)
            w.write16(asoc)

    def set_channels_rgb(self, with_alpha: bool = False) -> None:
        self.channels = [(0, 0, 1), (1, 0, 2), (2, 0, 3)]
        if with_alpha:
            self.channels.append((3, 1, 0))

    def dump_fields(self) -> List[str]:
        return [f"channel {ci}: type={ty} assoc={asoc}"
                for (ci, ty, asoc) in self.channels]


@register_box("cmap")
class Box_cmap(Box):
    """Component mapping (ref: jpeg2000_boxes.h:138 Box_cmap)."""

    def __init__(self):
        super().__init__()
        # (component_index, mapping_type, palette_column)
        self.components: List[Tuple[int, int, int]] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.components = []
        while r.remaining() >= 4:
            self.components.append((r.read16(), r.read8(), r.read8()))

    def write_payload(self, w: ByteWriter) -> None:
        for (cmp, mtyp, pcol) in self.components:
            w.write16(cmp)
            w.write8(mtyp)
            w.write8(pcol)

    def dump_fields(self) -> List[str]:
        return [f"component {c}: mtyp={m} pcol={p}"
                for (c, m, p) in self.components]


@register_box("pclr")
class Box_pclr(Box):
    """Palette (ref: jpeg2000_boxes.h:182 Box_pclr)."""

    def __init__(self):
        super().__init__()
        self.bit_depths: List[int] = []
        self.entries: List[List[int]] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        ne = r.read16()
        limits.check_children_count(ne, "pclr")
        npc = r.read8()
        self.bit_depths = [(r.read8() & 0x7F) + 1 for _ in range(npc)]
        self.entries = []
        for _ in range(ne):
            row = []
            for d in self.bit_depths:
                nbytes = (d + 7) // 8
                v = 0
                for _b in range(nbytes):
                    v = (v << 8) | r.read8()
                row.append(v)
            self.entries.append(row)

    def write_payload(self, w: ByteWriter) -> None:
        w.write16(len(self.entries))
        w.write8(len(self.bit_depths))
        for d in self.bit_depths:
            w.write8(d - 1)
        for row in self.entries:
            for v, d in zip(row, self.bit_depths):
                nbytes = (d + 7) // 8
                for b in range(nbytes - 1, -1, -1):
                    w.write8((v >> (8 * b)) & 0xFF)

    def dump_fields(self) -> List[str]:
        return [f"{len(self.entries)} entries × {len(self.bit_depths)} columns"
                f" depths={self.bit_depths}"]


@register_box("j2kL")
class Box_j2kL(FullBox):
    """JPEG 2000 layers (ref: jpeg2000_boxes.h:266 Box_j2kL)."""

    def __init__(self):
        super().__init__()
        # (layer_id, discard_levels, decode_layers)
        self.layers: List[Tuple[int, int, int]] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.parse_full_header(r)
        self.check_version()
        self.layers = []
        while r.remaining() >= 5:
            self.layers.append((r.read16(), r.read8(), r.read16()))

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        for (lid, dl, dec) in self.layers:
            w.write16(lid)
            w.write8(dl)
            w.write16(dec)

    def dump_fields(self) -> List[str]:
        return [f"layer {lid}: discard_levels={dl} decode_layers={dec}"
                for (lid, dl, dec) in self.layers]


@register_box("j2kH")
class Box_j2kH(Box):
    """JPEG 2000 header item property: container of cdef/cmap/pclr/j2kL
    (ref: jpeg2000_boxes.h:311 Box_j2kH; essential property)."""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.read_children(r, limits, depth)
