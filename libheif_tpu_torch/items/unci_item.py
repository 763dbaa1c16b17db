"""unci image item: the built-in ISO 23001-17 codec item.

Counterpart of libheif_tpu/items/unci_item.py (reference:
libheif/image-items/unc_image.{h,cc} — unc_image.h:41).  Each item keeps
one UnciDecoder, built on first use on the context's device.  A ``cpat``
property becomes the image's BayerPattern, which BayerToRGB reads.
"""

from __future__ import annotations

from typing import Optional, Set

from ..core.error import HeifError, SubError
from ..boxes.meta import Box_ispe
from ..boxes.unc import Box_uncC, Box_cmpd, Box_cmpC, Box_icef, Box_cpat
from ..codecs.unc import UnciDecoder
from ..image.pixel_image import (
    BayerPattern, COMPONENT_TYPE_TO_CHANNEL, PixelImage)
from .item import ImageItem, ImageTiling, register_item, DecodingOptions


@register_item("unci")
class ImageItem_unci(ImageItem):

    def __init__(self, ctx, item_id: int):
        super().__init__(ctx, item_id)
        self._decoder: Optional[UnciDecoder] = None

    def _get_decoder(self) -> UnciDecoder:
        if self._decoder is None:
            ispe = self.get_property(Box_ispe)
            if ispe is None:
                raise HeifError.invalid_input(SubError.No_ispe_property)
            self._decoder = UnciDecoder(
                self.get_property(Box_uncC),
                self.get_property(Box_cmpd),
                ispe.width, ispe.height,
                cmpC=self.get_property(Box_cmpC),
                icef=self.get_property(Box_icef),
                limits=self.ctx.limits,
                device=self.ctx.device)
        return self._decoder

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        dec = self._get_decoder()
        img = dec.decode(self.file.get_item_data(self.item_id))
        self._attach_bayer_pattern(img)
        return img

    def _attach_bayer_pattern(self, img: PixelImage) -> None:
        """Resolve a cpat property into a per-cell channel pattern on
        the image (ref: unc_codec.cc:294-330 — cpat cmpd-index →
        component mapping feeding Op_bayer_bilinear_to_RGB24_32)."""
        cpat = self.get_property(Box_cpat)
        if cpat is None:
            return
        cmpd = self.get_property(Box_cmpd)
        if cmpd is None:
            return
        channels = []
        for idx in cpat.components:
            if idx >= len(cmpd.components):
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    f"cpat component index {idx} out of cmpd range")
            ctype = cmpd.components[idx].component_type
            channels.append(COMPONENT_TYPE_TO_CHANNEL.get(ctype, ""))
        img.bayer_pattern = BayerPattern(
            pattern_width=cpat.pattern_width,
            pattern_height=cpat.pattern_height,
            channels=channels,
            gains=list(cpat.component_gains))

    def get_tiling(self) -> ImageTiling:
        lay = self._get_decoder().layout
        return ImageTiling(num_columns=lay.tile_cols, num_rows=lay.tile_rows,
                           tile_width=lay.tile_width,
                           tile_height=lay.tile_height,
                           image_width=lay.width, image_height=lay.height)

    def decode_tile(self, tile_x: int, tile_y: int,
                    options: Optional[DecodingOptions] = None) -> PixelImage:
        dec = self._get_decoder()
        return dec.decode_tile(self.file.get_item_data_view(self.item_id),
                               tile_x, tile_y)
