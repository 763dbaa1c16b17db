"""Items of 'mini'-format files.

Counterpart of libheif_tpu/items/mini_item.py (reference: libheif/mini.cc
create_expanded_boxes mini.h:40 — the reference expands the mini box into
real meta boxes; here, as in the JAX package, the context gets image
items made from it directly): the main image, its alpha image and the
Exif and XMP metadata.  The codec comes from the box's explicit type or
the file's brands; the main and alpha images decode on the context's
device with that codec's item decoder (``codec_items.CodedImageItem``).
"""

from __future__ import annotations

from typing import Optional, Set

from ..codecs import registry
from ..color.nclx import NclxProfile
from ..core.bitstream import ByteReader
from ..core.error import HeifError, SubError
from ..core.fourcc import fourcc_to_str
from ..core.limits import SecurityLimits
from ..image.pixel_image import PixelImage
from .codec_items import CodedImageItem
from .item import ImageItem, ITEM_REGISTRY, DecodingOptions

# brand → implied codec type (ref: mini.cc:1282 get_item_type_for_brand)
_BRAND_CODEC = {"avif": "av01", "avis": "av01", "mif3": None,
                "heic": "hvc1", "heix": "hvc1"}


class MiniImageItem(ImageItem):
    """Main or alpha image carried in a mini box."""

    def __init__(self, ctx, item_id: int, mini, role: str, infe_type: str):
        super().__init__(ctx, item_id)
        self.mini = mini
        self.role = role  # 'main' | 'alpha'
        self.item_type = infe_type

    def properties(self):
        return []

    @property
    def ispe_size(self):
        return (self.mini.width, self.mini.height)

    def width_height(self):
        return (self.mini.width, self.mini.height)

    def nclx(self) -> Optional[NclxProfile]:
        m = self.mini
        return NclxProfile(m.colour_primaries, m.transfer_characteristics,
                           m.matrix_coefficients, m.full_range_flag)

    def icc(self):
        return self.mini.icc_data or None

    def luma_bits_per_pixel(self) -> int:
        return self.mini.bit_depth

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        codec = ITEM_REGISTRY.get(self.item_type)
        if codec is None or not issubclass(codec, CodedImageItem):
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                f"no decoder available for mini codec {self.item_type!r}")
        if self.role == "alpha":
            config = self.mini.alpha_item_codec_config
            data = self.mini.alpha_item_data
        else:
            config = self.mini.main_item_codec_config
            data = self.mini.main_item_data
        dec = registry.decoder_for(
            codec.compression_format, options.decoder_id, self.ctx.device,
            f"no decoder available for mini codec {self.item_type!r}")
        return dec.decode_single_image(
            _config_box(codec.config_box_cls, config), data,
            declared_size=(self.mini.width, self.mini.height),
            limits=self.ctx.limits)


def _config_box(cls, raw: bytes):
    """The codec configuration box parsed from the mini's config bytes
    (a jpeg's become a jpgC, whose bytes go in front of the data, as
    libheif's expansion does; the JAX package ignores them)."""
    if not raw:
        return None
    b = cls()
    b.parse_payload(ByteReader(raw), SecurityLimits())
    return b


def make_mini_items(ctx) -> None:
    """Populate ctx.items from the mini box."""
    mini = ctx.file.mini
    if mini.infe_type:
        infe_type = fourcc_to_str(mini.infe_type)
    else:
        # mif3 files carry the codec brand in the ftyp minor_version
        # field (e.g. 'ftyp' mif3 avif); check major, minor-as-4cc and
        # the compatible list
        ftyp = ctx.file.ftyp
        brands = []
        if ftyp is not None:
            brands.append(ftyp.major_brand)
            brands.append(ftyp.minor_version.to_bytes(4, "big")
                          .decode("latin-1"))
            brands.extend(ftyp.compatible_brands)
        infe_type = "hvc1"
        for b in brands:
            mapped = _BRAND_CODEC.get(b)
            if mapped:
                infe_type = mapped
                break
            if b.startswith("avi"):
                infe_type = "av01"
                break
            if b in ("heic", "heix"):
                infe_type = "hvc1"
                break

    main = MiniImageItem(ctx, 1, mini, "main", infe_type)
    main.is_primary = True
    ctx.items[1] = main
    ctx.primary_id = 1

    if mini.alpha_flag and mini.alpha_item_data:
        alpha = MiniImageItem(ctx, 2, mini, "alpha", infe_type)
        alpha.is_aux = True
        alpha.premultiplied_alpha = mini.alpha_is_premultiplied
        ctx.items[2] = alpha
        main.alpha_item = alpha
        main.premultiplied_alpha = mini.alpha_is_premultiplied

    if mini.exif_flag and mini.exif_data:
        main.metadata.append({
            "item_id": -1, "item_type": "Exif", "content_type": "",
            "item_uri_type": "", "data": mini.exif_data})
    if mini.xmp_flag and mini.xmp_data:
        main.metadata.append({
            "item_id": -2, "item_type": "mime",
            "content_type": "application/rdf+xml",
            "item_uri_type": "", "data": mini.xmp_data})
