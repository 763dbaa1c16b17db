"""Standard HEIF/ISOBMFF metadata boxes.

Counterpart of libheif_tpu/boxes/meta.py (reference: libheif/box.{h,cc} —
box.h:401-2039), with every box it holds: the file-level boxes (ftyp,
meta, hdlr, pitm), the item tables (iloc, iinf/infe, iref, idat,
dinf/dref/url), the property containers (iprp/ipco/ipma), the properties
(ispe, pixi, irot, imir, clap, iscl, pasp, colr, auxC, lsel, clli, mdcv,
amve, ndwt, udes, elng, cclv, cmin, cmex, itai and the GIMI content-id
'uuid' box), the entity groups (grpl holding altr, ster, pymd), the TAI
clock box (taic), free/skip and mdat.
Every other box parses as :class:`Box_other` and round-trips unchanged.
Wire formats follow ISO/IEC 14496-12 and ISO/IEC 23008-12.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, SubError
from ..core.fraction import Fraction
from ..core.limits import SecurityLimits
from .box import Box, FullBox, register_box, register_uuid_box

# --------------------------------------------------------------------------
# File-level boxes
# --------------------------------------------------------------------------

@register_box("ftyp")
class Box_ftyp(Box):
    """File type box (ref: box.h:401 Box_ftyp)."""

    def __init__(self, major: str = "heic", minor: int = 0,
                 compatible: Optional[List[str]] = None):
        super().__init__()
        self.major_brand = major
        self.minor_version = minor
        self.compatible_brands: List[str] = list(compatible or [])

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.major_brand = r.read_bytes(4).decode("latin-1")
        self.minor_version = r.read32()
        self.compatible_brands = []
        n = 0
        while r.remaining() >= 4:
            self.compatible_brands.append(r.read_bytes(4).decode("latin-1"))
            n += 1
            if limits.max_number_of_file_brands and n > limits.max_number_of_file_brands:
                raise HeifError.security("too many compatible brands in ftyp")

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.major_brand.encode("latin-1"))
        w.write32(self.minor_version)
        for b in self.compatible_brands:
            w.write_bytes(b.encode("latin-1"))

    def has_compatible_brand(self, brand: str) -> bool:
        return brand in self.compatible_brands

    def dump_fields(self) -> List[str]:
        return [f"major brand: {self.major_brand}",
                f"minor version: {self.minor_version}",
                f"compatible brands: {','.join(self.compatible_brands)}"]


@register_box("meta")
class Box_meta(FullBox):
    """Meta box: container of hdlr/pitm/iloc/iinf/iprp/... (ref: box.h:427)."""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.read_children(r, limits, depth)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        self.write_children(w)


@register_box("hdlr")
class Box_hdlr(FullBox):
    """Handler box (ref: box.h:440)."""

    def __init__(self, handler_type: str = "pict"):
        super().__init__()
        self.pre_defined = 0
        self.handler_type = handler_type
        self.name = ""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.pre_defined = r.read32()
        self.handler_type = r.read_bytes(4).decode("latin-1")
        for _ in range(3):
            r.read32()
        self.name = r.read_string() if not r.eof() else ""

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(self.pre_defined)
        w.write_bytes(self.handler_type.encode("latin-1"))
        for _ in range(3):
            w.write32(0)
        w.write_string(self.name)

    def dump_fields(self) -> List[str]:
        return [f"handler_type: {self.handler_type}", f"name: {self.name}"]


@register_box("pitm")
class Box_pitm(FullBox):
    """Primary item box (ref: box.cc:1507)."""

    supported_versions = (0, 1)

    def __init__(self, item_id: int = 0):
        super().__init__()
        self.item_id = item_id

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.item_id = r.read16() if self.version == 0 else r.read32()

    def derive_version(self) -> None:
        self.version = 1 if self.item_id > 0xFFFF else 0

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if self.version == 0:
            w.write16(self.item_id)
        else:
            w.write32(self.item_id)

    def dump_fields(self) -> List[str]:
        return [f"item_ID: {self.item_id}"]


# --------------------------------------------------------------------------
# iloc
# --------------------------------------------------------------------------

@dataclass
class IlocExtent:
    index: int = 0
    offset: int = 0
    length: int = 0


@dataclass
class IlocItem:
    item_id: int = 0
    construction_method: int = 0  # 0=file offset, 1=idat, 2=item
    data_reference_index: int = 0
    base_offset: int = 0
    extents: List[IlocExtent] = field(default_factory=list)
    # True when method-0 extent offsets are relative to the mdat payload
    # being assembled for writing; False when they are absolute offsets
    # into a source file that was read (rebased before re-writing).
    mdat_relative: bool = False


@register_box("iloc")
class Box_iloc(FullBox):
    """Item location box (ref: box.cc:1566 Box_iloc::parse).

    On write, extents whose construction_method is 0 carry offsets
    relative to the start of the mdat payload; their absolute file
    positions are patched after mdat placement via
    :meth:`patch_iloc_offsets` (ref: patch_file_pointers box.h:199-201).
    """

    supported_versions = (0, 1, 2)

    def __init__(self):
        super().__init__()
        self.items: List[IlocItem] = []
        self.offset_size = 4
        self.length_size = 4
        self.base_offset_size = 0
        self.index_size = 0
        self._offset_patch_pos: List[Tuple[int, int, int]] = []  # (writer pos, item idx, extent idx)

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        b = r.read8()
        self.offset_size = b >> 4
        self.length_size = b & 0xF
        b = r.read8()
        self.base_offset_size = b >> 4
        self.index_size = (b & 0xF) if self.version in (1, 2) else 0

        item_count = r.read16() if self.version < 2 else r.read32()
        if limits.max_items and item_count > limits.max_items:
            raise HeifError.security(f"iloc with {item_count} items")

        self.items = []
        for _ in range(item_count):
            it = IlocItem()
            it.item_id = r.read16() if self.version < 2 else r.read32()
            if self.version in (1, 2):
                it.construction_method = r.read16() & 0xF
            it.data_reference_index = r.read16()
            it.base_offset = r.read_uint(self.base_offset_size)
            extent_count = r.read16()
            if limits.max_iloc_extents_per_item and \
                    extent_count > limits.max_iloc_extents_per_item:
                raise HeifError.security(
                    f"{extent_count} iloc extents for item {it.item_id}")
            for _ in range(extent_count):
                ext = IlocExtent()
                if self.version in (1, 2) and self.index_size > 0:
                    ext.index = r.read_uint(self.index_size)
                ext.offset = r.read_uint(self.offset_size)
                ext.length = r.read_uint(self.length_size)
                it.extents.append(ext)
            self.items.append(it)

    def find_item(self, item_id: int) -> Optional[IlocItem]:
        for it in self.items:
            if it.item_id == item_id:
                return it
        return None

    def derive_version(self) -> None:
        v = 0
        if any(it.item_id > 0xFFFF for it in self.items):
            v = 2
        elif any(it.construction_method != 0 for it in self.items):
            v = 1
        self.version = v
        # 64-bit offsets/lengths if needed
        big = any(e.offset > 0xFFFFFFFF or e.length > 0xFFFFFFFF
                  for it in self.items for e in it.extents)
        self.offset_size = self.length_size = 8 if big else 4

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        self._offset_patch_pos = []
        w.write8((self.offset_size << 4) | self.length_size)
        idx_nibble = self.index_size if self.version in (1, 2) else 0
        w.write8((self.base_offset_size << 4) | idx_nibble)
        if self.version < 2:
            w.write16(len(self.items))
        else:
            w.write32(len(self.items))
        for i, it in enumerate(self.items):
            if self.version < 2:
                w.write16(it.item_id)
            else:
                w.write32(it.item_id)
            if self.version in (1, 2):
                w.write16(it.construction_method)
            w.write16(it.data_reference_index)
            w.write_uint(it.base_offset, self.base_offset_size)
            w.write16(len(it.extents))
            for j, ext in enumerate(it.extents):
                if self.version in (1, 2) and self.index_size > 0:
                    w.write_uint(ext.index, self.index_size)
                if it.construction_method == 0:
                    self._offset_patch_pos.append((w.pos, i, j))
                w.write_uint(ext.offset, self.offset_size)
                w.write_uint(ext.length, self.length_size)

    def patch_iloc_offsets(self, w: ByteWriter, mdat_payload_start: int) -> None:
        """Rewrite method-0 extent offsets to absolute file positions."""
        for pos, i, j in self._offset_patch_pos:
            ext = self.items[i].extents[j]
            w.patch_uint(pos, ext.offset + mdat_payload_start, self.offset_size)

    def dump_fields(self) -> List[str]:
        out = []
        for it in self.items:
            exts = " ".join(f"[{e.offset}+{e.length}]" for e in it.extents)
            out.append(f"item {it.item_id}: method={it.construction_method} "
                       f"base={it.base_offset} extents: {exts}")
        return out


# --------------------------------------------------------------------------
# iinf / infe
# --------------------------------------------------------------------------

@register_box("infe")
class Box_infe(FullBox):
    """Item info entry (ref: box.cc:2390)."""

    supported_versions = (0, 1, 2, 3)

    def __init__(self, item_id: int = 0, item_type: str = "    ",
                 name: str = ""):
        super().__init__()
        self.version = 2
        self.item_id = item_id
        self.item_protection_index = 0
        self.item_type = item_type
        self.item_name = name
        self.content_type = ""
        self.content_encoding = ""
        self.item_uri_type = ""

    @property
    def hidden(self) -> bool:
        return bool(self.flags & 1)

    @hidden.setter
    def hidden(self, v: bool) -> None:
        self.flags = (self.flags & ~1) | int(v)

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        if self.version <= 1:
            self.item_id = r.read16()
            self.item_protection_index = r.read16()
            self.item_name = r.read_string()
            self.content_type = r.read_string() if not r.eof() else ""
            self.content_encoding = r.read_string() if not r.eof() else ""
            self.item_type = "mime" if self.content_type else ""
            return
        self.item_id = r.read16() if self.version == 2 else r.read32()
        self.item_protection_index = r.read16()
        self.item_type = r.read_bytes(4).decode("latin-1")
        self.item_name = r.read_string() if not r.eof() else ""
        if self.item_type == "mime":
            self.content_type = r.read_string() if not r.eof() else ""
            self.content_encoding = r.read_string() if not r.eof() else ""
        elif self.item_type == "uri ":
            self.item_uri_type = r.read_string() if not r.eof() else ""

    def derive_version(self) -> None:
        self.version = 3 if self.item_id > 0xFFFF else 2

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if self.version == 2:
            w.write16(self.item_id)
        else:
            w.write32(self.item_id)
        w.write16(self.item_protection_index)
        w.write_bytes(self.item_type.encode("latin-1"))
        w.write_string(self.item_name)
        if self.item_type == "mime":
            w.write_string(self.content_type)
            if self.content_encoding:
                w.write_string(self.content_encoding)
        elif self.item_type == "uri ":
            w.write_string(self.item_uri_type)

    def dump_fields(self) -> List[str]:
        f = [f"item_ID: {self.item_id}", f"item_type: {self.item_type}"]
        if self.item_name:
            f.append(f"item_name: {self.item_name}")
        if self.content_type:
            f.append(f"content_type: {self.content_type}")
        if self.hidden:
            f.append("hidden: true")
        return f


@register_box("iinf")
class Box_iinf(FullBox):
    """Item info box (ref: box.cc:2536)."""

    supported_versions = (0, 1)

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        count = r.read16() if self.version == 0 else r.read32()
        if limits.max_items and count > limits.max_items:
            raise HeifError.security(f"iinf with {count} entries")
        self.read_children(r, limits, depth, max_children=max(count, 1) + 1)

    def derive_version(self) -> None:
        self.version = 1 if len(self.children) > 0xFFFF else 0
        super().derive_version()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if self.version == 0:
            w.write16(len(self.children))
        else:
            w.write32(len(self.children))
        self.write_children(w)

    @property
    def entries(self) -> List[Box_infe]:
        return [c for c in self.children if isinstance(c, Box_infe)]


# --------------------------------------------------------------------------
# Properties: iprp / ipco / ipma and the property boxes
# --------------------------------------------------------------------------

@register_box("iprp")
class Box_iprp(Box):
    """Item properties container (ref: box.h:765)."""


@register_box("ipco")
class Box_ipco(Box):
    """Item property container (ref: box.h:779)."""

    def get_property(self, index_1based: int) -> Optional[Box]:
        if 1 <= index_1based <= len(self.children):
            return self.children[index_1based - 1]
        return None

    def find_or_append(self, box: Box) -> int:
        """Append a property with dedup, returning its 1-based index
        (ref: HeifFile property dedup, file.h:168-216)."""
        ser = box.serialize()
        for i, c in enumerate(self.children):
            if c.box_type == box.box_type and c.serialize() == ser:
                return i + 1
        self.children.append(box)
        return len(self.children)


@dataclass
class PropertyAssociation:
    property_index: int  # 1-based into ipco
    essential: bool


@register_box("ipma")
class Box_ipma(FullBox):
    """Item property association (ref: box.cc:3219)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.associations: Dict[int, List[PropertyAssociation]] = {}

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        entry_count = r.read32()
        if limits.max_items and entry_count > limits.max_items:
            raise HeifError.security(f"ipma with {entry_count} entries")
        for _ in range(entry_count):
            item_id = r.read16() if self.version < 1 else r.read32()
            assoc_count = r.read8()
            assocs = []
            for _ in range(assoc_count):
                if self.flags & 1:
                    v = r.read16()
                    assocs.append(PropertyAssociation(v & 0x7FFF, bool(v & 0x8000)))
                else:
                    v = r.read8()
                    assocs.append(PropertyAssociation(v & 0x7F, bool(v & 0x80)))
            self.associations[item_id] = assocs

    def get(self, item_id: int) -> List[PropertyAssociation]:
        return self.associations.get(item_id, [])

    def add(self, item_id: int, prop_index: int, essential: bool) -> None:
        lst = self.associations.setdefault(item_id, [])
        for a in lst:
            if a.property_index == prop_index:
                a.essential = a.essential or essential
                return
        lst.append(PropertyAssociation(prop_index, essential))

    def derive_version(self) -> None:
        self.version = 1 if any(i > 0xFFFF for i in self.associations) else 0
        big_index = any(a.property_index > 0x7F
                        for lst in self.associations.values() for a in lst)
        self.flags = 1 if big_index else 0

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(len(self.associations))
        for item_id, assocs in self.associations.items():
            if self.version < 1:
                w.write16(item_id)
            else:
                w.write32(item_id)
            w.write8(len(assocs))
            for a in assocs:
                if self.flags & 1:
                    w.write16((a.property_index & 0x7FFF) | (0x8000 if a.essential else 0))
                else:
                    w.write8((a.property_index & 0x7F) | (0x80 if a.essential else 0))

    def dump_fields(self) -> List[str]:
        return [f"item {i}: " + " ".join(
            f"{a.property_index}{'*' if a.essential else ''}" for a in lst)
            for i, lst in self.associations.items()]


@register_box("ispe")
class Box_ispe(FullBox):
    """Image spatial extents (ref: box.h:583)."""

    def __init__(self, width: int = 0, height: int = 0):
        super().__init__()
        self.width = width
        self.height = height

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.width = r.read32()
        self.height = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(self.width)
        w.write32(self.height)

    def dump_fields(self) -> List[str]:
        return [f"image width: {self.width}", f"image height: {self.height}"]


@register_box("pixi")
class Box_pixi(FullBox):
    """Pixel information (ref: box.cc:2651)."""

    def __init__(self, bits: Optional[List[int]] = None):
        super().__init__()
        self.bits_per_channel: List[int] = list(bits or [])

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        n = r.read8()
        self.bits_per_channel = [r.read8() for _ in range(n)]

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write8(len(self.bits_per_channel))
        for b in self.bits_per_channel:
            w.write8(b)

    def dump_fields(self) -> List[str]:
        return ["bits_per_channel: " + ",".join(map(str, self.bits_per_channel))]


@register_box("irot")
class Box_irot(Box):
    """Image rotation, CCW degrees (ref: box.cc:3496)."""

    def __init__(self, angle_ccw: int = 0):
        super().__init__()
        self.angle = angle_ccw  # 0/90/180/270

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.angle = (r.read8() & 0x3) * 90

    def write_payload(self, w: ByteWriter) -> None:
        w.write8(self.angle // 90)

    def dump_fields(self) -> List[str]:
        return [f"rotation: {self.angle} degrees (CCW)"]


@register_box("imir")
class Box_imir(Box):
    """Image mirroring (ref: box.cc:3532).

    axis 'vertical'   = mirror over a vertical axis (left-right flip),
    axis 'horizontal' = mirror over a horizontal axis (top-bottom flip).
    Wire: bit0 set → horizontal.
    """

    MIRROR_VERTICAL = "vertical"
    MIRROR_HORIZONTAL = "horizontal"

    def __init__(self, direction: str = MIRROR_VERTICAL):
        super().__init__()
        self.direction = direction

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.direction = (self.MIRROR_HORIZONTAL if (r.read8() & 1)
                          else self.MIRROR_VERTICAL)

    def write_payload(self, w: ByteWriter) -> None:
        w.write8(1 if self.direction == self.MIRROR_HORIZONTAL else 0)

    def dump_fields(self) -> List[str]:
        return [f"mirror direction: {self.direction}"]


@register_box("clap")
class Box_clap(Box):
    """Clean aperture (ref: box.cc:3633)."""

    def __init__(self, w: Optional[Fraction] = None, h: Optional[Fraction] = None,
                 hoff: Optional[Fraction] = None, voff: Optional[Fraction] = None):
        super().__init__()
        self.ap_width = w or Fraction(0, 1)
        self.ap_height = h or Fraction(0, 1)
        self.h_offset = hoff or Fraction(0, 1)
        self.v_offset = voff or Fraction(0, 1)

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        wn, wd = r.read32(), r.read32()
        hn, hd = r.read32(), r.read32()
        hon, hod = r.read32s(), r.read32()
        von, vod = r.read32s(), r.read32()
        for v in (wn, wd, hn, hd, hod, vod):
            if v > 0x7FFFFFFF:
                raise HeifError.invalid_input(
                    SubError.Invalid_fractional_number, "clap value out of range")
        self.ap_width = Fraction(wn, wd)
        self.ap_height = Fraction(hn, hd)
        self.h_offset = Fraction(hon, hod)
        self.v_offset = Fraction(von, vod)
        for f in (self.ap_width, self.ap_height, self.h_offset, self.v_offset):
            if not f.is_valid():
                raise HeifError.invalid_input(
                    SubError.Invalid_fractional_number, "invalid clap fraction")

    def write_payload(self, w: ByteWriter) -> None:
        w.write32(self.ap_width.numerator)
        w.write32(self.ap_width.denominator)
        w.write32(self.ap_height.numerator)
        w.write32(self.ap_height.denominator)
        w.write32s(self.h_offset.numerator)
        w.write32(self.h_offset.denominator)
        w.write32s(self.v_offset.numerator)
        w.write32(self.v_offset.denominator)

    # Cropping math (ref: Box_clap::left_rounded etc., box.cc):
    # left = horizOff + (width_image - apertureWidth)/2 , rounded.
    def left(self, image_width: int) -> int:
        x = self.h_offset + Fraction(image_width - 1, 2) - (self.ap_width - Fraction(1, 1)) / 2
        return x.round()

    def top(self, image_height: int) -> int:
        y = self.v_offset + Fraction(image_height - 1, 2) - (self.ap_height - Fraction(1, 1)) / 2
        return y.round()

    def width_rounded(self) -> int:
        return self.ap_width.round()

    def height_rounded(self) -> int:
        return self.ap_height.round()

    def dump_fields(self) -> List[str]:
        return [f"aperture: {self.ap_width.to_float():g}x{self.ap_height.to_float():g}"
                f" offset ({self.h_offset.to_float():g},{self.v_offset.to_float():g})"]


@register_box("iscl")
class Box_iscl(FullBox):
    """Image scaling (ref: box.cc:3582)."""

    def __init__(self):
        super().__init__()
        self.width_num = self.width_den = 1
        self.height_num = self.height_den = 1

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.width_num = r.read16()
        self.width_den = r.read16()
        self.height_num = r.read16()
        self.height_den = r.read16()
        if 0 in (self.width_num, self.width_den, self.height_num, self.height_den):
            raise HeifError.invalid_input(
                SubError.Invalid_fractional_number,
                "iscl has zero numerator or denominator")

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write16(self.width_num)
        w.write16(self.width_den)
        w.write16(self.height_num)
        w.write16(self.height_den)

    def dump_fields(self) -> List[str]:
        return [f"scale: {self.width_num}/{self.width_den} x "
                f"{self.height_num}/{self.height_den}"]


@register_box("pasp")
class Box_pasp(Box):
    """Pixel aspect ratio (ref: box.cc:2719)."""

    def __init__(self, h: int = 1, v: int = 1):
        super().__init__()
        self.h_spacing = h
        self.v_spacing = v

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.h_spacing = r.read32()
        self.v_spacing = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        w.write32(self.h_spacing)
        w.write32(self.v_spacing)

    def dump_fields(self) -> List[str]:
        return [f"hSpacing: {self.h_spacing}", f"vSpacing: {self.v_spacing}"]


@register_box("colr")
class Box_colr(Box):
    """Colour information (ref: libheif/nclx.h:201 Box_colr).

    colour_type 'nclx' carries CICP fields; 'prof'/'rICC' carry a raw
    ICC profile blob.
    """

    def __init__(self):
        super().__init__()
        self.colour_type = "nclx"
        # CICP (H.273); defaults match the reference color_profile_nclx
        self.colour_primaries = 2      # unspecified
        self.transfer_characteristics = 2
        self.matrix_coefficients = 2
        self.full_range_flag = True
        self.icc_profile = b""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.colour_type = r.read_bytes(4).decode("latin-1")
        if self.colour_type == "nclx":
            self.colour_primaries = r.read16()
            self.transfer_characteristics = r.read16()
            self.matrix_coefficients = r.read16()
            self.full_range_flag = bool(r.read8() & 0x80)
        elif self.colour_type in ("prof", "rICC"):
            if limits.max_color_profile_size and \
                    r.remaining() > limits.max_color_profile_size:
                raise HeifError.security("color profile too large")
            self.icc_profile = r.read_remaining()
        else:
            raise HeifError.invalid_input(
                SubError.Unknown_color_profile_type,
                f"unknown colour type {self.colour_type!r}")

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.colour_type.encode("latin-1"))
        if self.colour_type == "nclx":
            w.write16(self.colour_primaries)
            w.write16(self.transfer_characteristics)
            w.write16(self.matrix_coefficients)
            w.write8(0x80 if self.full_range_flag else 0)
        else:
            w.write_bytes(self.icc_profile)

    def dump_fields(self) -> List[str]:
        if self.colour_type == "nclx":
            return [f"colour_type: nclx",
                    f"primaries: {self.colour_primaries}, "
                    f"transfer: {self.transfer_characteristics}, "
                    f"matrix: {self.matrix_coefficients}, "
                    f"full range: {self.full_range_flag}"]
        return [f"colour_type: {self.colour_type}",
                f"ICC profile: {len(self.icc_profile)} bytes"]


@register_box("auxC")
class Box_auxC(FullBox):
    """Auxiliary type property (ref: box.h:1134)."""

    ALPHA_TYPES = ("urn:mpeg:hevc:2015:auxid:1",
                   "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
                   "urn:com:apple:photo:2020:aux:hdrgainmap")
    DEPTH_TYPES = ("urn:mpeg:hevc:2015:auxid:2",
                   "urn:mpeg:mpegB:cicp:systems:auxiliary:depth")

    def __init__(self, aux_type: str = ""):
        super().__init__()
        self.aux_type = aux_type
        self.aux_subtypes = b""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.aux_type = r.read_string()
        self.aux_subtypes = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_string(self.aux_type)
        w.write_bytes(self.aux_subtypes)

    def is_alpha(self) -> bool:
        return self.aux_type in ("urn:mpeg:hevc:2015:auxid:1",
                                 "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha")

    def is_depth(self) -> bool:
        return self.aux_type in self.DEPTH_TYPES

    def dump_fields(self) -> List[str]:
        return [f"aux type: {self.aux_type}"]


@register_box("lsel")
class Box_lsel(Box):
    """Layer selection (ref: box.cc:2752)."""

    def __init__(self, layer_id: int = 0):
        super().__init__()
        self.layer_id = layer_id

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.layer_id = r.read16()

    def write_payload(self, w: ByteWriter) -> None:
        w.write16(self.layer_id)

    def dump_fields(self) -> List[str]:
        return [f"layer_id: {self.layer_id}"]


@register_box("clli")
class Box_clli(Box):
    """Content light level (ref: box.cc:2783)."""

    def __init__(self, max_cll: int = 0, max_pall: int = 0):
        super().__init__()
        self.max_content_light_level = max_cll
        self.max_pic_average_light_level = max_pall

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.max_content_light_level = r.read16()
        self.max_pic_average_light_level = r.read16()

    def write_payload(self, w: ByteWriter) -> None:
        w.write16(self.max_content_light_level)
        w.write16(self.max_pic_average_light_level)

    def dump_fields(self) -> List[str]:
        return [f"max_content_light_level: {self.max_content_light_level}",
                f"max_pic_average_light_level: {self.max_pic_average_light_level}"]


@register_box("mdcv")
class Box_mdcv(Box):
    """Mastering display colour volume (ref: box.cc:2827)."""

    def __init__(self):
        super().__init__()
        self.display_primaries = [(0, 0), (0, 0), (0, 0)]  # (x,y) per RGB
        self.white_point = (0, 0)
        self.max_display_mastering_luminance = 0
        self.min_display_mastering_luminance = 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.display_primaries = [(r.read16(), r.read16()) for _ in range(3)]
        self.white_point = (r.read16(), r.read16())
        self.max_display_mastering_luminance = r.read32()
        self.min_display_mastering_luminance = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        for x, y in self.display_primaries:
            w.write16(x)
            w.write16(y)
        w.write16(self.white_point[0])
        w.write16(self.white_point[1])
        w.write32(self.max_display_mastering_luminance)
        w.write32(self.min_display_mastering_luminance)


@register_box("amve")
class Box_amve(Box):
    """Ambient viewing environment (ref: box.cc:2893)."""

    def __init__(self):
        super().__init__()
        self.ambient_illumination = 0
        self.ambient_light_x = 0
        self.ambient_light_y = 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.ambient_illumination = r.read32()
        self.ambient_light_x = r.read16()
        self.ambient_light_y = r.read16()

    def write_payload(self, w: ByteWriter) -> None:
        w.write32(self.ambient_illumination)
        w.write16(self.ambient_light_x)
        w.write16(self.ambient_light_y)


@register_box("ndwt")
class Box_ndwt(FullBox):
    """Nominal diffuse white (ref: box.cc:2930)."""

    def __init__(self, luminance: int = 0):
        super().__init__()
        self.diffuse_white_luminance = luminance

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.diffuse_white_luminance = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(self.diffuse_white_luminance)


@register_box("udes")
class Box_udes(FullBox):
    """User description (ref: box.cc:4687)."""

    def __init__(self, lang: str = "", name: str = "",
                 description: str = "", tags: str = ""):
        super().__init__()
        self.lang = lang
        self.name = name
        self.description = description
        self.tags = tags

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.lang = r.read_string()
        self.name = r.read_string() if not r.eof() else ""
        self.description = r.read_string() if not r.eof() else ""
        self.tags = r.read_string() if not r.eof() else ""

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_string(self.lang)
        w.write_string(self.name)
        w.write_string(self.description)
        w.write_string(self.tags)

    def dump_fields(self) -> List[str]:
        return [f"lang: {self.lang}", f"name: {self.name}",
                f"description: {self.description}", f"tags: {self.tags}"]


# --------------------------------------------------------------------------
# iref / idat / dinf
# --------------------------------------------------------------------------

@dataclass
class ItemReference:
    ref_type: str
    from_item_id: int
    to_item_ids: List[int]


@register_box("iref")
class Box_iref(FullBox):
    """Item reference box (ref: box.cc:3798)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.references: List[ItemReference] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        id_read = r.read16 if self.version == 0 else r.read32
        while not r.eof():
            size = r.read32()
            ref_type = r.read_bytes(4).decode("latin-1")
            if size < 8:
                raise HeifError.invalid_input(
                    SubError.Invalid_box_size, "iref reference too small")
            body = r.sub_reader(size - 8)
            sub_id_read = body.read16 if self.version == 0 else body.read32
            from_id = sub_id_read()
            count = body.read16()
            to_ids = [sub_id_read() for _ in range(count)]
            self.references.append(ItemReference(ref_type, from_id, to_ids))

    def derive_version(self) -> None:
        big = any(ref.from_item_id > 0xFFFF or any(t > 0xFFFF for t in ref.to_item_ids)
                  for ref in self.references)
        self.version = 1 if big else 0

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        for ref in self.references:
            idsz = 2 if self.version == 0 else 4
            size = 8 + idsz + 2 + idsz * len(ref.to_item_ids)
            w.write32(size)
            w.write_bytes(ref.ref_type.encode("latin-1"))
            wid = w.write16 if self.version == 0 else w.write32
            wid(ref.from_item_id)
            w.write16(len(ref.to_item_ids))
            for t in ref.to_item_ids:
                wid(t)

    # -- queries (ref: HeifFile::get_item_references) -------------------

    def get_references_from(self, item_id: int,
                            ref_type: Optional[str] = None) -> List[ItemReference]:
        return [ref for ref in self.references
                if ref.from_item_id == item_id
                and (ref_type is None or ref.ref_type == ref_type)]

    def get_references_to(self, item_id: int,
                          ref_type: Optional[str] = None) -> List[ItemReference]:
        return [ref for ref in self.references
                if item_id in ref.to_item_ids
                and (ref_type is None or ref.ref_type == ref_type)]

    def add_reference(self, ref_type: str, from_id: int, to_ids: List[int]) -> None:
        for ref in self.references:
            if ref.from_item_id == from_id and ref.ref_type == ref_type:
                ref.to_item_ids.extend(to_ids)
                return
        self.references.append(ItemReference(ref_type, from_id, list(to_ids)))

    def check_for_cycles(self) -> None:
        """Reject reference cycles (ref: file.h:311-316).

        Applies per reference type: the derived-image graph must be a DAG.
        Types are not merged, because a valid file links two items both
        ways through two types: 'auxl' from an alpha item to its master,
        'prem' from the master back to it.  (The JAX package merges them,
        so it rejects such files, its own writer's included.)
        """
        for ref_type in {ref.ref_type for ref in self.references}:
            adj: Dict[int, List[int]] = {}
            for ref in self.references:
                if ref.ref_type == ref_type:
                    adj.setdefault(ref.from_item_id, []).extend(
                        ref.to_item_ids)
            _check_acyclic(adj)

    def dump_fields(self) -> List[str]:
        return [f"{ref.ref_type}: {ref.from_item_id} -> {ref.to_item_ids}"
                for ref in self.references]


def _check_acyclic(adj: Dict[int, List[int]]) -> None:
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[int, int] = {}

    def visit(n: int, depth: int = 0) -> None:
        if depth > 1000:
            raise HeifError.usage(SubError.Item_reference_cycle,
                                  "item reference chain too deep")
        color[n] = GRAY
        for m in adj.get(n, []):
            c = color.get(m, WHITE)
            if c == GRAY:
                raise HeifError.usage(SubError.Item_reference_cycle,
                                      f"item reference cycle through item {m}")
            if c == WHITE:
                visit(m, depth + 1)
        color[n] = BLACK

    for n in list(adj):
        if color.get(n, WHITE) == WHITE:
            visit(n)


@register_box("idat")
class Box_idat(Box):
    """Item data box (ref: box.h:1714)."""

    def __init__(self, data: bytes = b""):
        super().__init__()
        self.data = data

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.data = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.data)

    def dump_fields(self) -> List[str]:
        return [f"{len(self.data)} data bytes"]


@register_box("dinf")
class Box_dinf(Box):
    """Data information box (ref: box.cc:4556)."""


@register_box("dref")
class Box_dref(FullBox):
    """Data reference box (ref: box.h:1745)."""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        count = r.read32()
        self.read_children(r, limits, depth, max_children=max(count, 1) + 1)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(len(self.children))
        self.write_children(w)


@register_box("url ")
class Box_url(FullBox):
    """Data entry URL box (ref: box.h:1760)."""

    def __init__(self):
        super().__init__()
        self.flags = 1  # self-contained
        self.location = ""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        if not (self.flags & 1):
            self.location = r.read_string()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if not (self.flags & 1):
            w.write_string(self.location)

    def is_self_contained(self) -> bool:
        return bool(self.flags & 1)


# --------------------------------------------------------------------------
# Entity groups
# --------------------------------------------------------------------------

@register_box("grpl")
class Box_grpl(Box):
    """Groups list box (ref: box.h:1167)."""


class Box_EntityToGroup(FullBox):
    """Generic entity group (ref: box.cc:4367)."""

    def __init__(self, group_id: int = 0, entity_ids: Optional[List[int]] = None):
        super().__init__()
        self.group_id = group_id
        self.entity_ids: List[int] = list(entity_ids or [])

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.group_id = r.read32()
        n = r.read32()
        if n > r.remaining() // 4:
            raise HeifError.eof(f"entity group claims {n} entities")
        if limits.max_size_entity_group and n > limits.max_size_entity_group:
            raise HeifError.security(f"entity group with {n} entities")
        self.entity_ids = [r.read32() for _ in range(n)]

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(self.group_id)
        w.write32(len(self.entity_ids))
        for e in self.entity_ids:
            w.write32(e)

    def dump_fields(self) -> List[str]:
        return [f"group id: {self.group_id}",
                f"entity IDs: {' '.join(map(str, self.entity_ids))}"]


@register_box("altr")
class Box_altr(Box_EntityToGroup):
    """Alternatives entity group."""


@register_box("ster")
class Box_ster(Box_EntityToGroup):
    """Stereo pair group (ref: box.cc:4456)."""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        super().parse_payload(r, limits, depth)
        if len(self.entity_ids) != 2:
            raise HeifError.invalid_input(
                SubError.Invalid_box_size,
                "'ster' group must contain exactly two images")


@dataclass
class PymdLayerInfo:
    layer_binning: int = 0
    tiles_in_layer_row_minus1: int = 0
    tiles_in_layer_column_minus1: int = 0


@register_box("pymd")
class Box_pymd(Box_EntityToGroup):
    """Multi-resolution pyramid group (ref: box.cc:4487)."""

    def __init__(self):
        super().__init__()
        self.tile_size_x = 0
        self.tile_size_y = 0
        self.layer_infos: List[PymdLayerInfo] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        super().parse_payload(r, limits, depth)
        self.tile_size_x = r.read16()
        self.tile_size_y = r.read16()
        self.layer_infos = []
        for _ in self.entity_ids:
            self.layer_infos.append(PymdLayerInfo(
                r.read16(), r.read16(), r.read16()))

    def write_payload(self, w: ByteWriter) -> None:
        super().write_payload(w)
        w.write16(self.tile_size_x)
        w.write16(self.tile_size_y)
        for li in self.layer_infos:
            w.write16(li.layer_binning)
            w.write16(li.tiles_in_layer_row_minus1)
            w.write16(li.tiles_in_layer_column_minus1)

    def dump_fields(self) -> List[str]:
        out = super().dump_fields()
        out.append(f"tile size: {self.tile_size_x}x{self.tile_size_y}")
        return out


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------

@register_box("free", "skip")
class Box_free(Box):
    """Free-space box (ref: box.h:2027)."""

    def __init__(self, size: int = 0):
        super().__init__()
        self.payload = b"\x00" * size

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.payload = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.payload)


@register_box("mdat")
class Box_mdat(Box):
    """Media data box.

    Parsed lazily: we record the absolute file offset/length of the
    payload rather than copying it, mirroring the reference's lazy mdat
    handling through FileLayout (file_layout.cc:38) — item data is read
    through iloc extents directly from the file buffer.
    """

    def __init__(self, payload: bytes = b""):
        super().__init__()
        self.payload = payload       # only used on the write path
        self.data_start = 0          # absolute file offset of payload (read path)
        self.data_size = 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.data_start = r.pos
        self.data_size = r.remaining()
        r.skip_to_end()

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.payload)

    def dump_fields(self) -> List[str]:
        return [f"{self.data_size or len(self.payload)} data bytes"]


# --------------------------------------------------------------------------
# TAI timestamps (ISO/IEC 23001-17 Amd: 'taic' clock info of a track's
# sample entry; per-sample timestamp packets in 'stai' aux info)
# --------------------------------------------------------------------------

@dataclass
class TaiClockInfo:
    """heif_tai_clock_info equivalent (ref: heif_tai_timestamps.h)."""
    time_uncertainty: int = 0xFFFFFFFFFFFFFFFF    # unknown
    clock_resolution: int = 0
    clock_drift_rate: int = 0x7FFFFFFF            # unknown
    clock_type: int = 0


@dataclass
class TaiTimestampPacket:
    """heif_tai_timestamp_packet equivalent."""
    tai_timestamp: int = 0        # ns since TAI epoch 1958-01-01
    synchronization_state: bool = False
    timestamp_generation_failure: bool = False
    timestamp_is_modified: bool = False

    def to_bytes(self) -> bytes:
        status = ((0x80 if self.synchronization_state else 0) |
                  (0x40 if self.timestamp_generation_failure else 0) |
                  (0x20 if self.timestamp_is_modified else 0))
        return self.tai_timestamp.to_bytes(8, "big") + bytes([status])

    @classmethod
    def from_bytes(cls, data: bytes) -> "TaiTimestampPacket":
        if len(data) < 9:
            raise HeifError.invalid_input(msg="TAI timestamp packet too short")
        status = data[8]
        return cls(tai_timestamp=int.from_bytes(data[:8], "big"),
                   synchronization_state=bool(status & 0x80),
                   timestamp_generation_failure=bool(status & 0x40),
                   timestamp_is_modified=bool(status & 0x20))


@register_box("taic")
class Box_taic(FullBox):
    """TAI clock information (ref: box.h:1812)."""

    def __init__(self, info: Optional[TaiClockInfo] = None):
        super().__init__()
        self.info = info or TaiClockInfo()

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.info = TaiClockInfo(
            time_uncertainty=r.read64(),
            clock_resolution=r.read32(),
            clock_drift_rate=r.read32s(),
            clock_type=r.read8() >> 6)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write64(self.info.time_uncertainty)
        w.write32(self.info.clock_resolution)
        w.write32s(self.info.clock_drift_rate)
        w.write8((self.info.clock_type & 3) << 6)

    def dump_fields(self) -> List[str]:
        return [f"time_uncertainty: {self.info.time_uncertainty}",
                f"clock_resolution: {self.info.clock_resolution}",
                f"clock_drift_rate: {self.info.clock_drift_rate}",
                f"clock_type: {self.info.clock_type}"]


@register_box("itai")
class Box_itai(FullBox):
    """Item TAI timestamp property (ref: box.h:1892)."""

    is_essential_default = False

    def __init__(self, ts: Optional[TaiTimestampPacket] = None):
        super().__init__()
        self.timestamp = ts or TaiTimestampPacket()

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        data = r.read_bytes(8) + r.read_bytes(1)
        self.timestamp = TaiTimestampPacket.from_bytes(data)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_bytes(self.timestamp.to_bytes())

    def dump_fields(self) -> List[str]:
        t = self.timestamp
        return [f"tai_timestamp: {t.tai_timestamp}",
                f"synchronization_state: {t.synchronization_state}",
                f"generation_failure: {t.timestamp_generation_failure}",
                f"is_modified: {t.timestamp_is_modified}"]


@register_box("elng")
class Box_elng(FullBox):
    """Extended language tag (ref: box.h:2000)."""

    def __init__(self, lang: str = ""):
        super().__init__()
        self.extended_language = lang

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.extended_language = r.read_string()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_string(self.extended_language)

    def dump_fields(self) -> List[str]:
        return [f"extended_language: {self.extended_language}"]


@register_box("cclv")
class Box_cclv(Box):
    """Content colour volume (ref: box.cc Box_cclv::parse).

    Optional primaries / min / max / avg luminance, gated by the flag
    byte.  Values are kept in their fixed-point wire representation.
    """

    def __init__(self):
        super().__init__()
        self.primaries = None       # [(x,y)]*3 as int32 pairs, or None
        self.min_luminance = None
        self.max_luminance = None
        self.avg_luminance = None

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        flags = r.read8()
        if flags & 0b00100000:
            self.primaries = [(r.read32s(), r.read32s()) for _ in range(3)]
        if flags & 0b00010000:
            self.min_luminance = r.read32()
        if flags & 0b00001000:
            self.max_luminance = r.read32()
        if flags & 0b00000100:
            self.avg_luminance = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        flags = ((0b00100000 if self.primaries is not None else 0) |
                 (0b00010000 if self.min_luminance is not None else 0) |
                 (0b00001000 if self.max_luminance is not None else 0) |
                 (0b00000100 if self.avg_luminance is not None else 0))
        w.write8(flags)
        if self.primaries is not None:
            for x, y in self.primaries:
                w.write32s(x)
                w.write32s(y)
        if self.min_luminance is not None:
            w.write32(self.min_luminance)
        if self.max_luminance is not None:
            w.write32(self.max_luminance)
        if self.avg_luminance is not None:
            w.write32(self.avg_luminance)


@register_box("cmin")
class Box_cmin(FullBox):
    """Camera intrinsic matrix (ref: box.cc Box_cmin::parse).

    Fixed-point values are stored raw (int32) together with the
    denominator shifts encoded in the flags, so round-trips are lossless.
    """

    def __init__(self):
        super().__init__()
        self.focal_length_x = 0
        self.principal_point_x = 0
        self.principal_point_y = 0
        self.focal_length_y = 0
        self.skew = 0

    @property
    def denominator_shift(self) -> int:
        return (self.flags & 0x1F00) >> 8

    @property
    def skew_denominator_shift(self) -> int:
        return (self.flags & 0x1F0000) >> 16

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.focal_length_x = r.read32s()
        self.principal_point_x = r.read32s()
        self.principal_point_y = r.read32s()
        if self.flags & 1:
            self.focal_length_y = r.read32s()
            self.skew = r.read32s()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32s(self.focal_length_x)
        w.write32s(self.principal_point_x)
        w.write32s(self.principal_point_y)
        if self.flags & 1:
            w.write32s(self.focal_length_y)
            w.write32s(self.skew)


@register_box("cmex")
class Box_cmex(FullBox):
    """Camera extrinsic matrix (ref: box.cc Box_cmex::parse).

    Presence of each field is governed by flag bits; rotation is a
    quaternion (v0, 16- or 32-bit) or yaw/pitch/roll (v1).  Raw
    fixed-point storage for lossless round-trip.
    """

    FLAG_POS_X = 1
    FLAG_POS_Y = 2
    FLAG_POS_Z = 4
    FLAG_ORIENTATION = 8
    FLAG_ROT_32BIT = 16
    FLAG_ID = 32

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.pos_x = self.pos_y = self.pos_z = 0
        self.quat = (0, 0, 0)           # raw ints (v0)
        self.rotation = (0, 0, 0)       # raw 16.16 yaw/pitch/roll (v1)
        self.world_coordinate_system_id = 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        f = self.flags
        if f & self.FLAG_POS_X:
            self.pos_x = r.read32s()
        if f & self.FLAG_POS_Y:
            self.pos_y = r.read32s()
        if f & self.FLAG_POS_Z:
            self.pos_z = r.read32s()
        if f & self.FLAG_ORIENTATION:
            if self.version == 0:
                if f & self.FLAG_ROT_32BIT:
                    self.quat = (r.read32s(), r.read32s(), r.read32s())
                else:
                    self.quat = (r.read16s(), r.read16s(), r.read16s())
            else:
                self.rotation = (r.read32s(), r.read32s(), r.read32s())
        if f & self.FLAG_ID:
            self.world_coordinate_system_id = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        f = self.flags
        if f & self.FLAG_POS_X:
            w.write32s(self.pos_x)
        if f & self.FLAG_POS_Y:
            w.write32s(self.pos_y)
        if f & self.FLAG_POS_Z:
            w.write32s(self.pos_z)
        if f & self.FLAG_ORIENTATION:
            if self.version == 0:
                if f & self.FLAG_ROT_32BIT:
                    for q in self.quat:
                        w.write32s(q)
                else:
                    for q in self.quat:
                        w.write16s(q)
            else:
                for v in self.rotation:
                    w.write32s(v)
        if f & self.FLAG_ID:
            w.write32(self.world_coordinate_system_id)


GIMI_CONTENT_ID_UUID = bytes([0x26, 0x1e, 0xf3, 0x74, 0x1d, 0x97, 0x5b, 0xba,
                              0xac, 0xbd, 0x9d, 0x2c, 0x8e, 0xa7, 0x35, 0x22])


@register_uuid_box(GIMI_CONTENT_ID_UUID)
class Box_gimi_content_id(Box):
    """GIMI content-ID uuid property (ref: box.h:1957)."""

    def __init__(self, content_id: str = ""):
        super().__init__()
        self.box_type = "uuid"
        self.uuid = GIMI_CONTENT_ID_UUID
        self.content_id = content_id

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.content_id = r.read_string()

    def write_payload(self, w: ByteWriter) -> None:
        w.write_string(self.content_id)

    def dump_fields(self) -> List[str]:
        return [f"content_id: {self.content_id}"]
