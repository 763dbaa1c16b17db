"""'tili' dynamically tiled image item (experimental 23008-12 tiling).

Counterpart of libheif_tpu/items/tiled_item.py, decode side (:54-272;
reference: libheif/image-items/tiled.h:148 — ImageItem_Tiled, TiledHeader
tiled.h:92; decode path tiled.cc:959-1035, offset-table IO
tiled.cc:363-556).

A tili item stores one offset table ("header") followed by the
concatenated per-tile bitstreams in its item data.  Tile codec
configuration lives as a shared property template in the tilC box.
Offsets are relative to the start of the item data, so a single tile of
a gigapixel image decodes from two small ranged reads (table entry, in
chunks of entries, and the tile's bytes).  Each tile decodes on the
context's device: unci tiles through one UnciDecoder kept by the item,
hvc1, av01, jpeg, avc1, j2k1 and vvc1 tiles through their item's decoder
(``codec_items.CodedImageItem``).  A full-image decode
is refused, as in the reference.  The write side (JAX :277-357):
``add_new_tiled_item`` makes an item with an empty offset table,
``add_image_tile`` encodes a tile on the context's device (unci through
UnciEncoder, the coded formats through the registry) and appends it,
and ``process_before_write`` patches the final table over the first.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ..core.error import HeifError, SubError, ErrorCode
from ..core.limits import SecurityLimits
from ..boxes.meta import Box_ispe
from ..boxes.tild import Box_tilC, TiledImageParameters
from ..boxes.unc import Box_uncC, Box_cmpd, Box_cmpC, Box_icef
from ..codecs import registry
from ..codecs.unc import UnciDecoder, UnciEncoder
from ..image.pixel_image import PixelImage, image_on_device
from ..option_types import EncodingOptions
from .codec_items import CodedImageItem
from .item import (ImageItem, ImageTiling, ITEM_REGISTRY, register_item,
                   DecodingOptions)

# special offset-table values (ref: tiled.h:89-91)
TILD_OFFSET_NOT_AVAILABLE = 0
TILD_OFFSET_SEE_LOWER_RESOLUTION_LAYER = 1
TILD_OFFSET_NOT_LOADED = 10

# registry format name of the tiles the port encodes -> infe fourcc
_FORMAT_TO_FOURCC = {"hevc": "hvc1", "av1": "av01", "vvc": "vvc1",
                     "jpeg": "jpeg", "avc": "avc1", "jpeg2000": "j2k1",
                     "unci": "unci"}
_FOURCC_TO_FORMAT = {v: k for k, v in _FORMAT_TO_FOURCC.items()}

# entries to fetch per offset-table read, so remote/streaming access
# amortizes transfer latency (ref: mReadChunkSize_bytes tiled.cc:1054)
_READ_CHUNK_ENTRIES = 1024


class TiledHeader:
    """Tile offset table of a tili item (ref: TiledHeader, tiled.h:92)."""

    def __init__(self, params: TiledImageParameters,
                 limits: Optional[SecurityLimits] = None):
        self.params = params
        n = params.number_of_tiles(limits)
        self._offsets: List[int] = [TILD_OFFSET_NOT_LOADED] * n
        self._sizes: List[int] = [0] * n

    # ------------------------------------------------------------ geometry

    @property
    def num_tiles(self) -> int:
        return len(self._offsets)

    def entry_size(self) -> int:
        """(ref: get_offset_table_entry_size, tiled.cc:430)."""
        return (self.params.offset_field_length +
                self.params.size_field_length) // 8

    def table_size(self) -> int:
        return self.num_tiles * self.entry_size()

    def is_offset_known(self, idx: int) -> bool:
        return self._offsets[idx] != TILD_OFFSET_NOT_LOADED

    def get_offset(self, idx: int) -> int:
        return self._offsets[idx]

    def get_size(self, idx: int) -> int:
        return self._sizes[idx]

    def range_to_read(self, idx: int,
                      n_entries: int) -> Tuple[int, int]:
        """[start, end) window of unknown entries around idx
        (ref: get_tile_offset_table_range_to_read, tiled.cc:436)."""
        if self.is_offset_known(idx):
            return (idx, idx)
        start, end = idx, idx + 1
        while end - start < n_entries and end < self.num_tiles and \
                not self.is_offset_known(end):
            end += 1
        while end - start < n_entries and start > 0 and \
                not self.is_offset_known(start - 1):
            start -= 1
        return (start, end)

    # ----------------------------------------------------------------- IO

    def read_range(self, file, item_id: int, start: int, end: int) -> None:
        """Parse entries [start, end) from the item data
        (ref: read_offset_table_range, tiled.cc:374)."""
        esz = self.entry_size()
        raw = file.get_item_data_range(item_id, start * esz,
                                       (end - start) * esz)
        off_bytes = self.params.offset_field_length // 8
        sz_bytes = self.params.size_field_length // 8
        pos = 0
        for i in range(start, end):
            self._offsets[i] = int.from_bytes(
                raw[pos:pos + off_bytes], "big")
            pos += off_bytes
            if sz_bytes:
                self._sizes[i] = int.from_bytes(
                    raw[pos:pos + sz_bytes], "big")
                pos += sz_bytes

    def read_full(self, file, item_id: int) -> None:
        self.read_range(file, item_id, 0, self.num_tiles)

    def set_tile_range(self, tile_x: int, tile_y: int, offset: int,
                       size: int) -> None:
        """Record a written tile; rejects field overflow at set time so
        the encoder fails early (ref: set_tild_tile_range, tiled.cc:471)."""
        p = self.params
        if p.offset_field_length < 64 and offset >> p.offset_field_length:
            raise HeifError(
                ErrorCode.Encoding_error,
                message=f"tile offset {offset} does not fit in "
                    f"{p.offset_field_length}-bit offset field")
        if 0 < p.size_field_length < 32 and size >> p.size_field_length:
            raise HeifError(
                ErrorCode.Encoding_error,
                message=f"tile size {size} does not fit in "
                    f"{p.size_field_length}-bit size field")
        idx = tile_y * p.tiles_h() + tile_x
        if idx >= self.num_tiles:
            raise HeifError.usage(msg="tile index out of range")
        self._offsets[idx] = offset
        self._sizes[idx] = size

    def serialize(self) -> bytes:
        """Offset table bytes (ref: write_offset_table, tiled.cc:512);
        unwritten tiles encode as offset 0 = not available."""
        p = self.params
        off_bytes = p.offset_field_length // 8
        sz_bytes = p.size_field_length // 8
        out = bytearray()
        for off, size in zip(self._offsets, self._sizes):
            if off == TILD_OFFSET_NOT_LOADED:
                off, size = TILD_OFFSET_NOT_AVAILABLE, 0
            out += off.to_bytes(off_bytes, "big")
            if sz_bytes:
                out += (size & ((1 << p.size_field_length) - 1)).to_bytes(
                    sz_bytes, "big")
        return bytes(out)


@register_item("tili")
class ImageItem_Tiled(ImageItem):
    """(ref: ImageItem_Tiled, tiled.h:148)."""

    def __init__(self, ctx, item_id: int):
        super().__init__(ctx, item_id)
        self._header: Optional[TiledHeader] = None
        self._tilC: Optional[Box_tilC] = None
        self._unci: Optional[UnciDecoder] = None
        self._next_position = 0      # encode side: the append cursor
        self._fmt: Optional[str] = None

    # --------------------------------------------------------------- common

    def _get_tilC(self) -> Box_tilC:
        if self._tilC is None:
            self._tilC = self.get_property(Box_tilC)
            if self._tilC is None:
                raise HeifError.invalid_input(
                    msg="'tili' item without tilC property")
        return self._tilC

    def _get_header(self) -> TiledHeader:
        if self._header is None:
            tilC = self._get_tilC()
            p = tilC.params
            ispe = self.get_property(Box_ispe)
            if ispe is not None:
                p.image_width, p.image_height = ispe.width, ispe.height
            if p.image_width == 0 or p.image_height == 0:
                raise HeifError.invalid_input(
                    msg="'tili' item without image dimensions")
            self._header = TiledHeader(p, self.ctx.limits)
        return self._header

    # --------------------------------------------------------------- decode

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        # full-image decode is deliberately unsupported, matching the
        # reference (tiled.cc:966-971): tili targets images too large to
        # materialize; callers use the tile API
        raise HeifError.unsupported(
            SubError.Unspecified,
            "'tili' images can only be accessed per tile")

    def get_tiling(self) -> ImageTiling:
        p = self._get_tilC().params
        hdr = self._get_header()
        return ImageTiling(num_columns=p.tiles_h(), num_rows=p.tiles_v(),
                           tile_width=p.tile_width,
                           tile_height=p.tile_height,
                           image_width=hdr.params.image_width,
                           image_height=hdr.params.image_height,
                           number_of_extra_dimensions=len(
                               p.extra_dimensions))

    def _tile_bitstream(self, tx: int, ty: int) -> bytes:
        """Two ranged reads: table entry (chunked) + tile bytes
        (ref: append_compressed_tile_data, tiled.cc:978)."""
        hdr = self._get_header()
        p = hdr.params
        idx = ty * p.tiles_h() + tx
        if tx >= p.tiles_h() or ty >= p.tiles_v():
            raise HeifError.usage(msg="tile index out of range")
        if not hdr.is_offset_known(idx):
            start, end = hdr.range_to_read(idx, _READ_CHUNK_ENTRIES)
            if start < end:
                hdr.read_range(self.file, self.item_id, start, end)
        offset, size = hdr.get_offset(idx), hdr.get_size(idx)
        if offset == TILD_OFFSET_NOT_AVAILABLE:
            raise HeifError.invalid_input(SubError.Missing_grid_images,
                                          f"tile ({tx},{ty}) not available")
        if offset == TILD_OFFSET_SEE_LOWER_RESOLUTION_LAYER:
            raise HeifError.unsupported(
                SubError.Unspecified,
                "tile refers to lower-resolution pyramid layer")
        return self.file.get_item_data_range(self.item_id, offset, size)

    def _unci_decoder(self) -> UnciDecoder:
        if self._unci is None:
            tilC = self._get_tilC()
            p = tilC.params
            self._unci = UnciDecoder(
                tilC.get_child(Box_uncC), tilC.get_child(Box_cmpd),
                p.tile_width, p.tile_height,
                cmpC=tilC.get_child(Box_cmpC),
                icef=tilC.get_child(Box_icef),
                limits=self.ctx.limits, device=self.ctx.device)
        return self._unci

    def decode_tile(self, tile_x: int, tile_y: int,
                    options: Optional[DecodingOptions] = None) -> PixelImage:
        """(ref: decode_grid_tile, tiled.cc:1033)."""
        tilC = self._get_tilC()
        p = tilC.params
        data = self._tile_bitstream(tile_x, tile_y)
        fourcc = p.compression_format

        if fourcc == "unci":
            return self._unci_decoder().decode(data)
        item_cls = ITEM_REGISTRY.get(fourcc)
        if item_cls is None or not issubclass(item_cls, CodedImageItem):
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                f"unsupported tili tile format {fourcc!r}")
        dec = registry.decoder_for(
            item_cls.compression_format,
            (options or DecodingOptions()).decoder_id, self.ctx.device)
        return dec.decode_single_image(
            tilC.get_child(item_cls.config_box_cls), data,
            declared_size=(p.tile_width, p.tile_height),
            limits=self.ctx.limits)

    # --------------------------------------------------------------- encode

    @classmethod
    def add_new_tiled_item(cls, ctx, params: TiledImageParameters,
                           fmt: str = "hevc") -> "ImageItem_Tiled":
        """Create an empty tili item ready for appended tiles
        (ref: add_new_tiled_item, tiled.cc:750)."""
        if fmt == "htj2k":
            # the JAX writer labels these tiles 'htj2' (the name cut to
            # four letters), a format no reader decodes
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "tili tiles of format 'htj2k' are not supported: the JAX "
                "writer labels them 'htj2', a format no reader decodes")
        if fmt not in _FORMAT_TO_FOURCC:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                f"tili tiles of format {fmt!r} are not supported by the "
                "port")
        params.compression_format = _FORMAT_TO_FOURCC[fmt]
        infe = ctx.file.add_new_item("tili")
        item = cls(ctx, infe.item_id)
        ctx.items[infe.item_id] = item

        tilC = Box_tilC(params)
        ctx.file.add_property(infe.item_id, tilC, True)
        item._tilC = tilC
        ctx.file.add_property(
            infe.item_id, Box_ispe(params.image_width, params.image_height),
            False)

        hdr = TiledHeader(params, ctx.limits)
        item._header = hdr
        table = hdr.serialize()
        ctx.file.append_item_data(infe.item_id, table)
        item._next_position = len(table)
        item._fmt = fmt
        return item

    def add_image_tile(self, tile_x: int, tile_y: int, img: PixelImage,
                       options=None) -> None:
        """Encode one tile on the context's device and append its
        bitstream (ref: add_image_tile, tiled.cc:833)."""
        options = options or EncodingOptions()
        tilC = self._get_tilC()
        p = tilC.params
        if img.width != p.tile_width or img.height != p.tile_height:
            raise HeifError.usage(
                msg="tile image size does not match the specified tile size")
        img = image_on_device(img, self.ctx.device)
        fmt = self._fmt or _FOURCC_TO_FORMAT.get(p.compression_format)
        if fmt == "unci":
            enc = UnciEncoder(1, 1)
            data = enc.encode_tile(img)
            cmpd, uncC = enc.make_boxes(img)
            props = [(cmpd, False), (uncC, True)]
        else:
            enc = registry.get_encoder(fmt) if fmt else None
            if enc is None:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec,
                    f"no encoder available for tili tiles of "
                    f"{p.compression_format!r}")
            data, cfg, extra = enc.encode_single_image(img, options)
            props = ([(cfg, True)] if cfg is not None else []) + \
                list(extra or [])

        hdr = self._get_header()
        offset = self._next_position
        hdr.set_tile_range(tile_x, tile_y, offset, len(data))
        self.file.append_item_data(self.item_id, data)
        self._next_position = offset + len(data)

        # shared tile-property template: first tile populates tilC children
        # (ispe skipped: synthesized from tile size; ref tiled.cc:886-936)
        existing = {c.box_type for c in tilC.children}
        for prop, _essential in props:
            if prop is None or prop.box_type == "ispe" or \
                    prop.box_type in existing:
                continue
            tilC.children.append(prop)
            existing.add(prop.box_type)

    def process_before_write(self) -> None:
        """Patch the final offset table over the placeholder
        (ref: process_before_write, tiled.cc:946)."""
        if self._header is None:
            return
        self.file.replace_item_data(self.item_id, 0,
                                    self._header.serialize())
