"""ISO/IEC 23001-17 "uncompressed" codec boxes: cmpd, uncC, cmpC, icef,
cpat, splz, sbpm, snuc, cloc.

Re-designed equivalents of the reference's unc box layer (reference:
libheif/codecs/uncompressed/unc_boxes.{h,cc} — Box_cmpd unc_boxes.h:41,
Box_uncC :87, Box_cmpC, Box_icef, Box_cpat, Box_splz :391, Box_sbpm :420,
Box_snuc :446, Box_cloc :472; enums unc_types.h:39,104,150).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, SubError
from ..core.fourcc import fourcc_to_str
from ..core.limits import SecurityLimits
from .box import Box, FullBox, register_box


class ComponentType(enum.IntEnum):
    """ISO 23001-17 Table 1 component types (ref: heif_uncompressed.h
    heif_cmpd_component_type)."""

    monochrome = 0
    Y = 1
    Cb = 2
    Cr = 3
    red = 4
    green = 5
    blue = 6
    alpha = 7
    depth = 8
    disparity = 9
    palette = 10
    filter_array = 11
    padded = 12
    cyan = 13
    magenta = 14
    yellow = 15
    key_black = 16


class ComponentFormat(enum.IntEnum):
    """ISO 23001-17 Table 2 (ref: unc_types.h:39)."""

    unsigned = 0
    float = 1
    complex = 2
    signed = 3


class SamplingMode(enum.IntEnum):
    """ISO 23001-17 Table 3 (ref: unc_types.h:104)."""

    no_subsampling = 0
    s422 = 1
    s420 = 2
    s411 = 3


class InterleaveMode(enum.IntEnum):
    """ISO 23001-17 Table 4 (ref: unc_types.h:150)."""

    component = 0
    pixel = 1
    mixed = 2
    row = 3
    tile_component = 4
    multi_y = 5


@dataclass
class CmpdComponent:
    component_type: int = 0
    component_type_uri: str = ""

    def type_name(self) -> str:
        try:
            return ComponentType(self.component_type).name
        except ValueError:
            return f"0x{self.component_type:x}"


@register_box("cmpd")
class Box_cmpd(Box):
    """Component definition box (ref: unc_boxes.cc:143 Box_cmpd::parse)."""

    def __init__(self, components: Optional[List[CmpdComponent]] = None):
        super().__init__()
        self.components: List[CmpdComponent] = list(components or [])

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        n = r.read32()
        if limits.max_components and n > limits.max_components:
            raise HeifError.security(f"cmpd with {n} components")
        self.components = []
        for _ in range(n):
            if r.eof():
                raise HeifError.eof("cmpd truncated")
            c = CmpdComponent(r.read16())
            if c.component_type >= 0x8000:
                c.component_type_uri = r.read_string()
            self.components.append(c)

    def write_payload(self, w: ByteWriter) -> None:
        w.write32(len(self.components))
        for c in self.components:
            w.write16(c.component_type)
            if c.component_type >= 0x8000:
                w.write_string(c.component_type_uri)

    def dump_fields(self) -> List[str]:
        return [f"component_type: {c.type_name()}" for c in self.components]


@dataclass
class UncCComponent:
    component_index: int = 0
    component_bit_depth: int = 8
    component_format: int = 0
    component_align_size: int = 0


# uncC v1 profiles the reference accepts (unc_boxes.cc:247-268)
_V1_PROFILES = {"rgb3", "rgba", "abgr", "2vuy", "yuv2", "yvyu", "vyuy",
                "yuv1", "v308", "v408", "y210", "v410", "v210", "i420",
                "nv12", "nv21", "yu22", "yv22", "yv20"}


@register_box("uncC")
class Box_uncC(FullBox):
    """Uncompressed frame configuration (ref: unc_boxes.cc:239)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.profile = 0
        self.components: List[UncCComponent] = []
        self.sampling_type = SamplingMode.no_subsampling
        self.interleave_type = InterleaveMode.component
        self.block_size = 0
        self.components_little_endian = False
        self.block_pad_lsb = False
        self.block_little_endian = False
        self.block_reversed = False
        self.pad_unknown = False
        self.pixel_size = 0
        self.row_align_size = 0
        self.tile_align_size = 0
        self.num_tile_cols = 1
        self.num_tile_rows = 1

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.profile = r.read32()
        if self.version == 1:
            if fourcc_to_str(self.profile) not in _V1_PROFILES:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    f"unknown uncC v1 profile {fourcc_to_str(self.profile)!r}")
            return

        n = r.read32()
        if limits.max_components and n > limits.max_components:
            raise HeifError.security(f"uncC with {n} components")
        self.components = []
        for _ in range(n):
            if r.eof():
                break
            c = UncCComponent(
                component_index=r.read16(),
                component_bit_depth=r.read8() + 1,
                component_format=r.read8(),
                component_align_size=r.read8(),
            )
            if c.component_format > ComponentFormat.signed:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value, "invalid component format")
            if c.component_align_size and c.component_align_size * 8 < c.component_bit_depth:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    "component alignment smaller than bit depth")
            self.components.append(c)

        st = r.read8()
        if st > SamplingMode.s411:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value, "invalid sampling mode")
        self.sampling_type = SamplingMode(st)
        it = r.read8()
        if it > InterleaveMode.multi_y:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value, "invalid interleave mode")
        self.interleave_type = InterleaveMode(it)
        self.block_size = r.read8()
        flags = r.read8()
        self.components_little_endian = bool(flags & 0x80)
        self.block_pad_lsb = bool(flags & 0x40)
        self.block_little_endian = bool(flags & 0x20)
        self.block_reversed = bool(flags & 0x10)
        self.pad_unknown = bool(flags & 0x08)
        self.pixel_size = r.read32()
        if limits.max_iso23001_17_pixel_size_bytes and \
                self.pixel_size > limits.max_iso23001_17_pixel_size_bytes:
            raise HeifError.security(
                f"uncC pixel_size {self.pixel_size} exceeds limit")
        self.row_align_size = r.read32()
        self.tile_align_size = r.read32()
        cols_m1 = r.read32()
        rows_m1 = r.read32()
        if cols_m1 == 0xFFFFFFFF or rows_m1 == 0xFFFFFFFF:
            raise HeifError.unsupported(
                SubError.Invalid_parameter_value, "2^32 tiles unsupported")
        self.num_tile_cols = cols_m1 + 1
        self.num_tile_rows = rows_m1 + 1
        limits.check_tile_count(self.num_tile_cols, self.num_tile_rows)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(self.profile)
        if self.version == 1:
            return
        w.write32(len(self.components))
        for c in self.components:
            w.write16(c.component_index)
            w.write8(c.component_bit_depth - 1)
            w.write8(c.component_format)
            w.write8(c.component_align_size)
        w.write8(int(self.sampling_type))
        w.write8(int(self.interleave_type))
        w.write8(self.block_size)
        flags = ((0x80 if self.components_little_endian else 0)
                 | (0x40 if self.block_pad_lsb else 0)
                 | (0x20 if self.block_little_endian else 0)
                 | (0x10 if self.block_reversed else 0)
                 | (0x08 if self.pad_unknown else 0))
        w.write8(flags)
        w.write32(self.pixel_size)
        w.write32(self.row_align_size)
        w.write32(self.tile_align_size)
        w.write32(self.num_tile_cols - 1)
        w.write32(self.num_tile_rows - 1)

    def dump_fields(self) -> List[str]:
        out = [f"profile: {fourcc_to_str(self.profile) if self.profile else '(none)'}"]
        if self.version == 0:
            for c in self.components:
                out.append(f"component idx={c.component_index} "
                           f"depth={c.component_bit_depth} fmt={c.component_format} "
                           f"align={c.component_align_size}")
            out.append(f"sampling: {self.sampling_type.name}, "
                       f"interleave: {self.interleave_type.name}, "
                       f"block_size: {self.block_size}")
            out.append(f"pixel_size: {self.pixel_size}, row_align: "
                       f"{self.row_align_size}, tile_align: {self.tile_align_size}")
            out.append(f"tiles: {self.num_tile_cols}x{self.num_tile_rows}")
        return out


class CompressedUnitType(enum.IntEnum):
    """cmpC compressed unit granularity (ref: heif_uncompressed.h)."""

    whole_image = 0
    tile = 1
    row = 2
    pixel = 3


@register_box("cmpC")
class Box_cmpC(FullBox):
    """Generic compression configuration (ref: unc_boxes.cc:749)."""

    def __init__(self):
        super().__init__()
        self.compression_type = "\x00\x00\x00\x00"  # 'zlib'|'defl'|'brot'
        self.compressed_unit_type = CompressedUnitType.whole_image

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.compression_type = r.read_bytes(4).decode("latin-1")
        ut = r.read8()
        if ut > CompressedUnitType.pixel:
            raise HeifError.usage(SubError.Unsupported_parameter,
                                  "unsupported cmpC unit type")
        self.compressed_unit_type = CompressedUnitType(ut)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_bytes(self.compression_type.encode("latin-1"))
        w.write8(int(self.compressed_unit_type))

    def dump_fields(self) -> List[str]:
        return [f"compression_type: {self.compression_type}",
                f"unit_type: {self.compressed_unit_type.name}"]


@dataclass
class CompressedUnitInfo:
    unit_offset: int = 0
    unit_size: int = 0


_ICEF_OFFSET_BITS = (0, 16, 24, 32, 64)
_ICEF_SIZE_BITS = (8, 16, 24, 32, 64)


@register_box("icef")
class Box_icef(FullBox):
    """Generically compressed unit item info (ref: unc_boxes.cc:797)."""

    def __init__(self):
        super().__init__()
        self.unit_infos: List[CompressedUnitInfo] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        codes = r.read8()
        offset_code = (codes >> 5) & 0x7
        size_code = (codes >> 2) & 0x7
        if offset_code > 4 or size_code > 4:
            raise HeifError.usage(SubError.Unsupported_parameter,
                                  "unsupported icef offset/size code")
        n = r.read32()
        off_bits = _ICEF_OFFSET_BITS[offset_code]
        sz_bits = _ICEF_SIZE_BITS[size_code]
        if n * (off_bits + sz_bits) // 8 > r.remaining():
            raise HeifError.eof(f"icef declares {n} units beyond box size")
        self.unit_infos = []
        implied = 0
        for _ in range(n):
            off = implied if offset_code == 0 else r.read_uint(off_bits // 8)
            size = r.read_uint(sz_bits // 8)
            if offset_code == 0:
                implied += size
            self.unit_infos.append(CompressedUnitInfo(off, size))

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        # choose the smallest codes that fit
        max_off = max((u.unit_offset for u in self.unit_infos), default=0)
        max_sz = max((u.unit_size for u in self.unit_infos), default=0)
        offset_code = next(i for i, b in enumerate(_ICEF_OFFSET_BITS)
                           if i > 0 and max_off < (1 << b))
        size_code = next(i for i, b in enumerate(_ICEF_SIZE_BITS)
                         if max_sz < (1 << b))
        w.write8((offset_code << 5) | (size_code << 2))
        w.write32(len(self.unit_infos))
        for u in self.unit_infos:
            w.write_uint(u.unit_offset, _ICEF_OFFSET_BITS[offset_code] // 8)
            w.write_uint(u.unit_size, _ICEF_SIZE_BITS[size_code] // 8)

    def dump_fields(self) -> List[str]:
        return [f"num_compressed_units: {len(self.unit_infos)}"]


@register_box("cpat")
class Box_cpat(FullBox):
    """Filter-array (Bayer) pattern definition (ref: unc_boxes.h Box_cpat)."""

    def __init__(self):
        super().__init__()
        self.pattern_width = 0
        self.pattern_height = 0
        self.components: List[int] = []     # component index per pattern cell
        self.component_gains: List[float] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.pattern_width = r.read16()
        self.pattern_height = r.read16()
        n = self.pattern_width * self.pattern_height
        if limits.max_bayer_pattern_pixels and n > limits.max_bayer_pattern_pixels:
            raise HeifError.security(f"cpat pattern of {n} pixels")
        if self.pattern_width == 0 or self.pattern_height == 0:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value, "invalid cpat pattern size")
        self.components = []
        self.component_gains = []
        for _ in range(n):
            self.components.append(r.read32())
            gain_num = r.read16s()
            gain_den = r.read16s()
            if gain_den == 0:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value, "cpat gain denominator 0")
            self.component_gains.append(gain_num / gain_den)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write16(self.pattern_width)
        w.write16(self.pattern_height)
        for comp, gain in zip(self.components, self.component_gains):
            w.write32(comp)
            w.write16s(int(round(gain)))
            w.write16s(1)


def _read_f32(r: ByteReader) -> float:
    import struct
    return struct.unpack(">f", r.read_bytes(4))[0]


def _write_f32(w: ByteWriter, v: float) -> None:
    import struct
    w.write_bytes(struct.pack(">f", v))


@register_box("splz")
class Box_splz(FullBox):
    """Polarization pattern definition (ref: unc_boxes.h:391 Box_splz,
    parse unc_boxes.cc:1090): per-cell polarization filter angles over
    a repeating pattern, float32 degrees (NaN = no filter)."""

    def __init__(self):
        super().__init__()
        self.component_ids: List[int] = []
        self.pattern_width = 0
        self.pattern_height = 0
        self.polarization_angles: List[float] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        n_comp = r.read32()
        if limits.max_components and n_comp > limits.max_components:
            raise HeifError.security("splz component count")
        self.component_ids = [r.read32() for _ in range(n_comp)]
        self.pattern_width = r.read16()
        self.pattern_height = r.read16()
        if self.pattern_width == 0 or self.pattern_height == 0:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value,
                "zero polarization pattern size")
        if limits.max_bayer_pattern_pixels and self.pattern_height > \
                limits.max_bayer_pattern_pixels // self.pattern_width:
            raise HeifError.security("polarization pattern size")
        n = self.pattern_width * self.pattern_height
        self.polarization_angles = [_read_f32(r) for _ in range(n)]

    def write_payload(self, w: ByteWriter) -> None:
        if len(self.polarization_angles) != \
                self.pattern_width * self.pattern_height:
            raise HeifError.usage(SubError.Invalid_parameter_value,
                                  "wrong polarization angle count")
        self.write_full_header(w)
        w.write32(len(self.component_ids))
        for cid in self.component_ids:
            w.write32(cid)
        w.write16(self.pattern_width)
        w.write16(self.pattern_height)
        for a in self.polarization_angles:
            _write_f32(w, a)

    def dump_fields(self) -> List[str]:
        return [f"components: {self.component_ids}",
                f"pattern: {self.pattern_width}x{self.pattern_height}"]


@dataclass
class BadPixel:
    row: int = 0
    column: int = 0


@register_box("sbpm")
class Box_sbpm(FullBox):
    """Sensor bad-pixels map (ref: unc_boxes.h:420 Box_sbpm, parse
    unc_boxes.cc:1195)."""

    def __init__(self):
        super().__init__()
        self.component_ids: List[int] = []
        self.correction_applied = False
        self.bad_rows: List[int] = []
        self.bad_columns: List[int] = []
        self.bad_pixels: List[BadPixel] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        n_comp = r.read32()
        if limits.max_components and n_comp > limits.max_components:
            raise HeifError.security("sbpm component count")
        self.component_ids = [r.read32() for _ in range(n_comp)]
        self.correction_applied = bool(r.read8() & 0x80)
        n_rows = r.read32()
        n_cols = r.read32()
        n_pix = r.read32()
        if limits.max_bad_pixels and \
                n_rows + n_cols + n_pix > limits.max_bad_pixels:
            raise HeifError.security("sbpm bad pixel entries")
        self.bad_rows = [r.read32() for _ in range(n_rows)]
        self.bad_columns = [r.read32() for _ in range(n_cols)]
        self.bad_pixels = [BadPixel(r.read32(), r.read32())
                           for _ in range(n_pix)]

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write32(len(self.component_ids))
        for cid in self.component_ids:
            w.write32(cid)
        w.write8(0x80 if self.correction_applied else 0)
        w.write32(len(self.bad_rows))
        w.write32(len(self.bad_columns))
        w.write32(len(self.bad_pixels))
        for v in self.bad_rows:
            w.write32(v)
        for v in self.bad_columns:
            w.write32(v)
        for p in self.bad_pixels:
            w.write32(p.row)
            w.write32(p.column)

    def dump_fields(self) -> List[str]:
        return [f"components: {self.component_ids}",
                f"correction_applied: {self.correction_applied}",
                f"bad rows/cols/pixels: {len(self.bad_rows)}/"
                f"{len(self.bad_columns)}/{len(self.bad_pixels)}"]


@register_box("snuc")
class Box_snuc(FullBox):
    """Sensor non-uniformity correction: per-pixel gain/offset planes
    (ref: unc_boxes.h:446 Box_snuc, parse unc_boxes.cc:1319)."""

    def __init__(self):
        super().__init__()
        self.component_ids: List[int] = []
        self.nuc_is_applied = False
        self.image_width = 0
        self.image_height = 0
        self.nuc_gains: List[float] = []
        self.nuc_offsets: List[float] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        n_comp = r.read32()
        if limits.max_components and n_comp > limits.max_components:
            raise HeifError.security("snuc component count")
        self.component_ids = [r.read32() for _ in range(n_comp)]
        self.nuc_is_applied = bool(r.read8() & 0x80)
        self.image_width = r.read32()
        self.image_height = r.read32()
        if self.image_width == 0 or self.image_height == 0:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value,
                "snuc image size must be non-zero")
        n = self.image_width * self.image_height
        if limits.max_image_size_pixels and n > limits.max_image_size_pixels:
            raise HeifError.security("snuc image size")
        limits.check_block_size(n * 8, "snuc box")
        import struct
        raw = r.read_bytes(8 * n)
        self.nuc_gains = list(struct.unpack(f">{n}f", raw[:4 * n]))
        self.nuc_offsets = list(struct.unpack(f">{n}f", raw[4 * n:]))

    def write_payload(self, w: ByteWriter) -> None:
        import struct
        self.write_full_header(w)
        w.write32(len(self.component_ids))
        for cid in self.component_ids:
            w.write32(cid)
        w.write8(0x80 if self.nuc_is_applied else 0)
        w.write32(self.image_width)
        w.write32(self.image_height)
        n = self.image_width * self.image_height
        w.write_bytes(struct.pack(f">{n}f", *self.nuc_gains))
        w.write_bytes(struct.pack(f">{n}f", *self.nuc_offsets))

    def dump_fields(self) -> List[str]:
        return [f"components: {self.component_ids}",
                f"nuc_is_applied: {self.nuc_is_applied}",
                f"size: {self.image_width}x{self.image_height}"]


@register_box("cloc")
class Box_cloc(FullBox):
    """Chroma sample location (ref: unc_boxes.h:472 Box_cloc; values
    0-6 per H.273 chroma_sample_loc_type)."""

    def __init__(self):
        super().__init__()
        self.chroma_location = 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.chroma_location = r.read8()
        if self.chroma_location > 6:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value,
                "cloc chroma_location out of range (0-6)")

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write8(self.chroma_location)

    def dump_fields(self) -> List[str]:
        return [f"chroma_location: {self.chroma_location}"]
