"""'tilC' box of the experimental 'tili' dynamically tiled images.

Counterpart of libheif_tpu/boxes/tild.py (``TiledImageParameters``,
``Box_tilC`` :72-133; reference: libheif/image-items/tiled.h:43 — Box_tilC;
parse/write at tiled.cc:55-214; parameter struct
heif_tiled_image_parameters, api/libheif/heif_experimental.h:120-142).

The tilC property carries the tile grid geometry, the compression
format of the tiles, and a template set of tile properties (codec
config boxes shared by every tile).  Flags encode the offset/size
field widths of the offset table stored at the start of the item data:
bits 0-1 offset width (32/40/48/64), bits 2-3 size width (0/24/32/64),
bit 4 sequential-ordering hint.  The box also writes itself, so that a
file holding a tili item can be laid out with ``HeifFile``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, SubError
from ..core.limits import SecurityLimits
from .box import FullBox, register_box

_OFFSET_BITS = {0: 32, 1: 40, 2: 48, 3: 64}
_SIZE_BITS = {0: 0, 1: 24, 2: 32, 3: 64}


@dataclass
class TiledImageParameters:
    """(ref: heif_tiled_image_parameters, heif_experimental.h:120)."""

    version: int = 1
    image_width: int = 0
    image_height: int = 0
    tile_width: int = 0
    tile_height: int = 0
    compression_format: str = "unci"   # infe-type fourcc of the tiles
    offset_field_length: int = 40
    size_field_length: int = 24
    number_of_extra_dimensions: int = 0
    extra_dimensions: List[int] = field(default_factory=list)
    tiles_are_sequential: bool = True

    def tiles_h(self) -> int:
        return (self.image_width + self.tile_width - 1) // self.tile_width

    def tiles_v(self) -> int:
        return (self.image_height + self.tile_height - 1) // self.tile_height

    def number_of_tiles(self, limits: SecurityLimits = None) -> int:
        """(ref: number_of_tiles, tiled.cc:43-…): grid tiles times extra
        dimensions, bounded by the tile-count security limit."""
        n = self.tiles_h() * self.tiles_v()
        if limits is not None and limits.max_number_of_tiles and \
                n > limits.max_number_of_tiles:
            raise HeifError.security(
                "number of tiles exceeds security limit")
        for i, dim in enumerate(self.extra_dimensions[:8]):
            if dim == 0:
                raise HeifError.invalid_input(
                    msg="'tili' extra dimension may not be zero")
            n *= dim
            if limits is not None and limits.max_number_of_tiles and \
                    n > limits.max_number_of_tiles:
                raise HeifError.security(
                    "number of tiles exceeds security limit")
        return n


@register_box("tilC")
class Box_tilC(FullBox):
    """(ref: Box_tilC, tiled.h:43)."""

    supported_versions = (0, 1)

    def __init__(self, params: TiledImageParameters = None):
        super().__init__()
        self.params = params or TiledImageParameters()

    @property
    def is_essential(self) -> bool:
        return True

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth: int = 0) -> None:
        # a few in-the-wild images use version 1 (ref: tiled.cc:59-64)
        if self.version > 1:
            raise HeifError.unsupported(
                SubError.Unsupported_data_version,
                f"'tili' image version {self.version} is not implemented")
        p = self.params
        p.version = self.version
        p.offset_field_length = _OFFSET_BITS[self.flags & 0x03]
        p.size_field_length = _SIZE_BITS[(self.flags >> 2) & 0x03]
        p.tiles_are_sequential = bool(self.flags & 0x10)

        p.tile_width = r.read32()
        p.tile_height = r.read32()
        fourcc_raw = r.read32()
        p.compression_format = fourcc_raw.to_bytes(4, "big").decode(
            "latin-1")
        if p.tile_width == 0 or p.tile_height == 0:
            raise HeifError.invalid_input(
                msg="tile with zero width or height")

        p.number_of_extra_dimensions = r.read8()
        p.extra_dimensions = []
        for i in range(p.number_of_extra_dimensions):
            size = r.read32()
            if size == 0:
                raise HeifError.invalid_input(
                    msg="'tili' extra dimension may not be zero")
            if i < 8:
                p.extra_dimensions.append(size)

        # version-0 header embeds the tile property boxes
        # (ref: tiled.cc:160-170)
        if self.version == 0:
            num_props = r.read8()
            self.read_children(r, limits, depth, max_children=num_props)

    def derive_version(self) -> None:
        """(ref: Box_tilC::derive_box_version, tiled.cc:131-180)."""
        super().derive_version()
        self.version = 0
        flags = {32: 0, 40: 1, 48: 2, 64: 3}[self.params.offset_field_length]
        flags |= {0: 0, 24: 0x04, 32: 0x08, 64: 0x0c}[
            self.params.size_field_length]
        if self.params.tiles_are_sequential:
            flags |= 0x10
        self.flags = flags

    def write_payload(self, w: ByteWriter) -> None:
        p = self.params
        self.write_full_header(w)
        w.write32(p.tile_width)
        w.write32(p.tile_height)
        w.write_bytes(p.compression_format.encode("latin-1")[:4].ljust(
            4, b"\0"))
        dims = p.extra_dimensions[:8]
        w.write8(len(dims))
        for d in dims:
            w.write32(d)
        if len(self.children) > 255:
            from ..core.error import ErrorCode
            raise HeifError(ErrorCode.Encoding_error,
                            message="more than 255 tile properties in tilC")
        w.write8(len(self.children))
        self.write_children(w)

    def dump_fields(self) -> List[str]:
        p = self.params
        return [f"tile size: {p.tile_width}x{p.tile_height}",
                f"compression: {p.compression_format}",
                f"offsets: {p.offset_field_length} bit, "
                f"sizes: {p.size_field_length} bit",
                f"sequential: {int(p.tiles_are_sequential)}",
                f"extra dimensions: {p.extra_dimensions}"]
