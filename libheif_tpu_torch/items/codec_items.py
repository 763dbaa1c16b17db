"""Coded image items: hvc1, av01, vvc1, jpeg, avc1 and j2k1.

Counterpart of libheif_tpu/items/codec_items.py:27-94 (reference:
libheif/image-items/hevc.{h,cc} ImageItem_HEVC hevc.h:34,
avif.{h,cc} ImageItem_AVIF avif.h:36, jpeg.{h,cc} ImageItem_JPEG
jpeg.h:31, avc.{h,cc} ImageItem_AVC avc.h:34, jpeg2000.{h,cc}
ImageItem_JPEG2000 jpeg2000.h:33, vvc.h:31 ImageItem_VVC).  An item
resolves its configuration box (hvcC, av1C, vvcC, jpgC, avcC, j2kH) and
hands the payload to the decoder that the codec registry selects for its
format and ``DecodingOptions.decoder_id`` (JAX codec_items.py:43), which
reconstructs on the context's device (``CodedImageItem``; AVC, VVC and
JPEG 2000 decode on the host and copy their planes to the device once);
``tili`` tiles and ``mini`` images find their codec's format here too.
"""

from __future__ import annotations

from typing import Set

from ..boxes.codec_cfg import Box_av1C, Box_avcC, Box_hvcC, Box_jpgC, \
    Box_vvcC
from ..boxes.j2k import Box_j2kH
from ..boxes.meta import Box_ispe
from ..codecs import registry
from ..image.pixel_image import PixelImage
from .item import ImageItem, register_item, DecodingOptions


class CodedImageItem(ImageItem):
    """An item whose pixels come from a codec: its configuration box
    (``config_box_cls``) and payload go to the registry's decoder of its
    ``compression_format``, which reconstructs on the context's device."""

    compression_format = "unknown"
    config_box_cls = None

    def config_box(self):
        return self.get_property(self.config_box_cls)

    def coded_data(self) -> bytes:
        return self.file.get_item_data(self.item_id)

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        ispe = self.get_property(Box_ispe)
        size = (ispe.width, ispe.height) if ispe else None
        dec = registry.decoder_for(self.compression_format,
                                   options.decoder_id, self.ctx.device)
        return dec.decode_single_image(
            self.config_box(), self.coded_data(), declared_size=size,
            limits=self.ctx.limits)


@register_item("hvc1")
class ImageItem_HEVC(CodedImageItem):
    """(ref: hevc.h:34)."""

    compression_format = "hevc"
    config_box_cls = Box_hvcC


@register_item("av01")
class ImageItem_AVIF(CodedImageItem):
    """(ref: avif.h:36)."""

    compression_format = "av1"
    config_box_cls = Box_av1C


@register_item("vvc1")
class ImageItem_VVC(CodedImageItem):
    """(ref: vvc.h:31)."""

    compression_format = "vvc"
    config_box_cls = Box_vvcC


@register_item("jpeg")
class ImageItem_JPEG(CodedImageItem):
    """(ref: jpeg.h:31).  A jpgC's bytes go in front of the item data
    (codecs/jpeg JpegDecoder.decode_single_image)."""

    compression_format = "jpeg"
    config_box_cls = Box_jpgC


@register_item("avc1")
class ImageItem_AVC(CodedImageItem):
    """(ref: avc.h:34)."""

    compression_format = "avc"
    config_box_cls = Box_avcC


@register_item("j2k1")
class ImageItem_JPEG2000(CodedImageItem):
    """(ref: jpeg2000.h:33)."""

    compression_format = "jpeg2000"
    config_box_cls = Box_j2kH
