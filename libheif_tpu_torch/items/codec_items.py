"""Coded image items: hvc1, av01, vvc1, jpeg, avc1 and j2k1.

Counterpart of libheif_tpu/items/codec_items.py:27-94 (reference:
libheif/image-items/hevc.{h,cc} ImageItem_HEVC hevc.h:34,
avif.{h,cc} ImageItem_AVIF avif.h:36, jpeg.{h,cc} ImageItem_JPEG
jpeg.h:31, avc.{h,cc} ImageItem_AVC avc.h:34, jpeg2000.{h,cc}
ImageItem_JPEG2000 jpeg2000.h:33, vvc.h:31 ImageItem_VVC).  An item
resolves its configuration box (hvcC, av1C, vvcC, jpgC, avcC, j2kH) and
hands the payload to its decoder, which reconstructs on the context's
device (``CodedImageItem``; AVC, VVC and JPEG 2000 decode on the host
and copy their planes to the device once); ``tili`` tiles and ``mini``
images find their codec's decoder here too.
"""

from __future__ import annotations

from typing import Set

from ..boxes.codec_cfg import Box_av1C, Box_avcC, Box_hvcC, Box_jpgC, \
    Box_vvcC
from ..boxes.j2k import Box_j2kH
from ..boxes.meta import Box_ispe
from ..codecs.av1 import Av1Decoder
from ..codecs.avc import AvcDecoder
from ..codecs.hevc import HevcDecoder
from ..codecs.j2k import J2KImageDecoder
from ..codecs.jpeg import JpegDecoder
from ..codecs.vvc import VvcDecoder
from ..image.pixel_image import PixelImage
from .item import ImageItem, register_item, DecodingOptions


class CodedImageItem(ImageItem):
    """An item whose pixels come from a codec: its configuration box
    (``config_box_cls``) and payload go to its decoder (``decoder_cls``),
    which reconstructs on the context's device."""

    config_box_cls = None
    decoder_cls = None

    def config_box(self):
        return self.get_property(self.config_box_cls)

    def coded_data(self) -> bytes:
        return self.file.get_item_data(self.item_id)

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        ispe = self.get_property(Box_ispe)
        size = (ispe.width, ispe.height) if ispe else None
        return self.decoder_cls(self.ctx.device).decode_single_image(
            self.config_box(), self.coded_data(), declared_size=size,
            limits=self.ctx.limits)


@register_item("hvc1")
class ImageItem_HEVC(CodedImageItem):
    """(ref: hevc.h:34)."""

    config_box_cls = Box_hvcC
    decoder_cls = HevcDecoder


@register_item("av01")
class ImageItem_AVIF(CodedImageItem):
    """(ref: avif.h:36)."""

    config_box_cls = Box_av1C
    decoder_cls = Av1Decoder


@register_item("vvc1")
class ImageItem_VVC(CodedImageItem):
    """(ref: vvc.h:31)."""

    config_box_cls = Box_vvcC
    decoder_cls = VvcDecoder


@register_item("jpeg")
class ImageItem_JPEG(CodedImageItem):
    """(ref: jpeg.h:31).  A jpgC's bytes go in front of the item data
    (JpegDecoder.decode_single_image)."""

    config_box_cls = Box_jpgC
    decoder_cls = JpegDecoder


@register_item("avc1")
class ImageItem_AVC(CodedImageItem):
    """(ref: avc.h:34)."""

    config_box_cls = Box_avcC
    decoder_cls = AvcDecoder


@register_item("j2k1")
class ImageItem_JPEG2000(CodedImageItem):
    """(ref: jpeg2000.h:33)."""

    config_box_cls = Box_j2kH
    decoder_cls = J2KImageDecoder
