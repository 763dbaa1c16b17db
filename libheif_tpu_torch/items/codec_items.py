"""Coded image items: hvc1 and av01.

Counterpart of libheif_tpu/items/codec_items.py:27-69 (reference:
libheif/image-items/hevc.{h,cc} ImageItem_HEVC hevc.h:34,
avif.{h,cc} ImageItem_AVIF avif.h:36).  An item resolves its
configuration box (hvcC, av1C) and hands the payload to its decoder,
which reconstructs on the context's device.
"""

from __future__ import annotations

from typing import Set

from ..boxes.codec_cfg import Box_av1C, Box_hvcC
from ..boxes.meta import Box_ispe
from ..codecs.av1 import Av1Decoder
from ..codecs.hevc import HevcDecoder
from ..image.pixel_image import PixelImage
from .item import ImageItem, register_item, DecodingOptions


@register_item("hvc1")
class ImageItem_HEVC(ImageItem):
    """(ref: hevc.h:34)."""

    def config_box(self):
        return self.get_property(Box_hvcC)

    def coded_data(self) -> bytes:
        return self.file.get_item_data(self.item_id)

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        ispe = self.get_property(Box_ispe)
        size = (ispe.width, ispe.height) if ispe else None
        return HevcDecoder(self.ctx.device).decode_single_image(
            self.config_box(), self.coded_data(), declared_size=size,
            limits=self.ctx.limits)


@register_item("av01")
class ImageItem_AVIF(ImageItem):
    """(ref: avif.h:36)."""

    def config_box(self):
        return self.get_property(Box_av1C)

    def coded_data(self) -> bytes:
        return self.file.get_item_data(self.item_id)

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        ispe = self.get_property(Box_ispe)
        size = (ispe.width, ispe.height) if ispe else None
        return Av1Decoder(self.ctx.device).decode_single_image(
            self.config_box(), self.coded_data(), declared_size=size,
            limits=self.ctx.limits)
