"""ImageItem base class and the item decode pipeline.

Counterpart of libheif_tpu/items/item.py (reference:
libheif/image-items/image_item.{h,cc} — ImageItem image_item.h:55,
alloc_for_infe_box :63, decode pipeline image_item.cc:882-1081,
ImageItem_Error :520).

The decode pipeline keeps the reference's order: decode_compressed_image
→ decoded-size security check and crop to ispe → colour profile →
transform properties (irot/imir/clap) in association order → alpha aux
decode + attach.  Planes stay torch tensors on the owning context's
device throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Type

from ..core.error import HeifError, SubError
from ..boxes.meta import (
    Box_ispe, Box_irot, Box_imir, Box_clap, Box_colr, Box_pixi,
)
from ..image.pixel_image import PixelImage, Channel
from ..color.nclx import NclxProfile

ITEM_REGISTRY: Dict[str, Type["ImageItem"]] = {}


def register_item(*types: str) -> Callable[[Type["ImageItem"]], Type["ImageItem"]]:
    def deco(cls):
        for t in types:
            ITEM_REGISTRY[t] = cls
        cls.item_type = types[0]
        return cls
    return deco


@dataclass
class ImageTiling:
    """(ref: heif_image_tiling, heif_tiling.h:37)."""

    num_columns: int = 1
    num_rows: int = 1
    tile_width: int = 0
    tile_height: int = 0
    image_width: int = 0
    image_height: int = 0
    top_offset: int = 0
    left_offset: int = 0
    number_of_extra_dimensions: int = 0


@dataclass
class DecodingOptions:
    """(ref: heif_decoding_options v10, heif_decoding.h:63-158).

    The JAX package's ``prefer_device_grid`` has no counterpart: an hvc1
    grid always decodes in batches on the device.  ``mesh``
    (parallel/mesh.py ``make_mesh``) shards an hvc1 grid's tiles over its
    members (parallel/coded_grid.py decode_tiles_device); None decodes
    them on the context's device.  ``decoder_id`` pins the codec
    registry's decoder of a coded item's format (codecs/registry.py); an
    id that names none raises ``Unsupported_codec``, as in JAX."""

    ignore_transformations: bool = False
    convert_hdr_to_8bit: bool = False
    strict_decoding: bool = False
    ignore_aux_alpha: bool = False
    decoder_id: Optional[str] = None
    # color-conversion options applied to the decoded output
    # (ref: heif_decoding_options.color_conversion_options /
    # heif_color_conversion_options_ext incl. alpha composition)
    color_conversion_options: Optional[object] = None
    # progress/cancel callbacks
    on_progress: Optional[Callable[[int, int], None]] = None
    cancel: Optional[Callable[[], bool]] = None
    # host tile-decode thread count of the grid path on the CPU (the
    # analog of heif_context_set_max_decoding_threads, context.h:72);
    # None = use the owning context's max_decoding_threads
    max_decoding_threads: Optional[int] = None
    # a DeviceMesh (parallel/mesh.py) over which an hvc1 grid's tiles
    # decode; None = one batch on the context's device
    mesh: Optional[object] = None


def alloc_item(ctx, item_id: int, item_type: str) -> "ImageItem":
    """Factory (ref: ImageItem::alloc_for_infe_box image_item.h:63)."""
    cls = ITEM_REGISTRY.get(item_type)
    if cls is None:
        return ImageItem_Error(ctx, item_id, item_type,
                               HeifError.unsupported(
                                   SubError.Unsupported_image_type,
                                   f"unknown item type {item_type!r}"))
    return cls(ctx, item_id)


class ImageItem:
    """One image item in the file's item graph."""

    item_type = "????"
    is_image_item = True

    def __init__(self, ctx, item_id: int):
        self.ctx = ctx              # HeifContext
        self.item_id = item_id
        self.init_error: Optional[HeifError] = None
        # linked aux items (wired by HeifContext._interpret)
        self.thumbnails: List[ImageItem] = []
        self.alpha_item: Optional[ImageItem] = None
        self.depth_item: Optional[ImageItem] = None
        self.aux_items: List[ImageItem] = []
        self.metadata: List[dict] = []
        self.is_primary = False
        self.is_hidden = False
        self.is_thumbnail = False
        self.is_aux = False
        self.premultiplied_alpha = False

    # ------------------------------------------------------------ properties

    @property
    def file(self):
        return self.ctx.file

    def properties(self) -> List:
        return self.file.get_properties(self.item_id)

    def get_property(self, cls):
        return self.file.get_property(self.item_id, cls)

    @property
    def ispe_size(self):
        ispe = self.get_property(Box_ispe)
        if ispe is None:
            return None
        return (ispe.width, ispe.height)

    def width_height(self):
        """Post-transform display size (ref: ImageItem::get_width/height
        after irot)."""
        size = self.ispe_size
        if size is None:
            return (0, 0)
        w, h = size
        for prop in self.properties():
            if isinstance(prop, Box_irot) and prop.angle in (90, 270):
                w, h = h, w
            elif isinstance(prop, Box_clap):
                w = prop.width_rounded()
                h = prop.height_rounded()
        return (w, h)

    def nclx(self) -> Optional[NclxProfile]:
        for prop in self.properties():
            if isinstance(prop, Box_colr) and prop.colour_type == "nclx":
                return NclxProfile.from_colr_box(prop)
        return None

    def icc(self) -> Optional[bytes]:
        for prop in self.properties():
            if isinstance(prop, Box_colr) and prop.colour_type in ("prof", "rICC"):
                return prop.icc_profile
        return None

    def luma_bits_per_pixel(self) -> int:
        pixi = self.get_property(Box_pixi)
        if pixi and pixi.bits_per_channel:
            return pixi.bits_per_channel[0]
        return 8

    # ---------------------------------------------------------------- decode

    def decode_image(self, options: Optional[DecodingOptions] = None,
                     processed_ids: Optional[Set[int]] = None) -> PixelImage:
        """Full item decode incl. transforms and alpha
        (ref: ImageItem::decode_image image_item.cc:882)."""
        options = options or DecodingOptions()
        processed_ids = processed_ids if processed_ids is not None else set()
        if self.item_id in processed_ids:
            raise HeifError.usage(SubError.Item_reference_cycle,
                                  f"decode cycle through item {self.item_id}")
        processed_ids = processed_ids | {self.item_id}

        if self.init_error is not None:
            raise self.init_error

        # ispe size limit check (ref: image_item.cc:906)
        size = self.ispe_size
        if size is not None:
            self.ctx.limits.check_image_size(*size)

        img = self.decode_compressed_image(options, processed_ids)

        # decoded size vs declared size: a slightly larger decode is
        # cropped to ispe (codec alignment padding, ref: context crop to
        # ispe); anything else is an error/warning
        # (ref: check_decoded_image_size image_item.h:376)
        if size is not None and (img.width, img.height) != size:
            if img.width >= size[0] and img.height >= size[1] and \
                    img.width <= size[0] + 64 and img.height <= size[1] + 64:
                img = img.crop(0, 0, size[0], size[1])
            elif options.strict_decoding:
                raise HeifError.invalid_input(
                    SubError.Invalid_image_size,
                    f"decoded size {img.width}x{img.height} != ispe "
                    f"{size[0]}x{size[1]}")
            else:
                img.add_warning(HeifError.invalid_input(
                    SubError.Invalid_image_size,
                    "decoded size differs from ispe"))

        # color profile from properties
        nclx = self.nclx()
        if nclx is not None:
            img.color_profile_nclx = nclx
        icc = self.icc()
        if icc:
            img.color_profile_icc = icc

        # transforms in property association order (ref: image_item.cc:949)
        if not options.ignore_transformations:
            img = self.apply_transforms(img)

        # alpha aux attach (ref: image_item.cc:1030-1081)
        if self.alpha_item is not None and not options.ignore_aux_alpha and \
                not img.has_channel(Channel.Alpha):
            try:
                alpha_img = self.alpha_item.decode_image(options, processed_ids)
                if (alpha_img.width, alpha_img.height) != (img.width, img.height):
                    alpha_img = alpha_img.scale_nearest(img.width, img.height)
                if alpha_img.has_channel(Channel.Y):
                    img.set_plane(Channel.Alpha, alpha_img.plane(Channel.Y),
                                  alpha_img.bit_depth(Channel.Y))
                    img.premultiplied_alpha = self.premultiplied_alpha
            except HeifError as e:
                if options.strict_decoding:
                    raise
                img.add_warning(e)

        return img

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"no decoder for item type {self.item_type!r}")

    def apply_transforms(self, img: PixelImage) -> PixelImage:
        for prop in self.properties():
            if isinstance(prop, Box_irot):
                img = img.rotate_ccw(prop.angle)
            elif isinstance(prop, Box_imir):
                img = img.mirror(prop.direction)
            elif isinstance(prop, Box_clap):
                left = prop.left(img.width)
                top = prop.top(img.height)
                w = prop.width_rounded()
                h = prop.height_rounded()
                if left < 0 or top < 0 or w <= 0 or h <= 0 or \
                        left + w > img.width or top + h > img.height:
                    raise HeifError.invalid_input(
                        SubError.Invalid_clean_aperture,
                        "clap region outside image")
                img = img.crop(left, top, w, h)
        return img

    # --------------------------------------------------------------- tiling

    def get_tiling(self) -> ImageTiling:
        """(ref: heif_image_tiling, heif_tiling.h:37; items that tile
        override this)."""
        size = self.ispe_size or (0, 0)
        return ImageTiling(num_columns=1, num_rows=1,
                           tile_width=size[0], tile_height=size[1],
                           image_width=size[0], image_height=size[1])

    def decode_tile(self, tile_x: int, tile_y: int,
                    options: Optional[DecodingOptions] = None) -> PixelImage:
        """Decode a single tile (ref: heif_tiling.h:86).  Non-tiled items
        treat tile (0,0) as the whole image."""
        if tile_x == 0 and tile_y == 0:
            return self.decode_image(options)
        raise HeifError.usage(SubError.Invalid_parameter_value,
                              "item is not tiled")

    def __repr__(self):
        return f"<{type(self).__name__} id={self.item_id} '{self.item_type}'>"


class ImageItem_Error(ImageItem):
    """Placeholder for items that failed to initialize
    (ref: ImageItem_Error image_item.h:520) — keeps the item graph
    intact; decoding surfaces the stored error."""

    def __init__(self, ctx, item_id: int, item_type: str, error: HeifError):
        super().__init__(ctx, item_id)
        self.item_type = item_type
        self.init_error = error

    def decode_compressed_image(self, options, processed_ids):
        raise self.init_error
