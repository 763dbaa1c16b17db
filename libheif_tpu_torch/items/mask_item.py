"""mski mask image items (ISO 23008-12 §6.10.2).

Counterpart of libheif_tpu/items/mask_item.py (reference:
libheif/image-items/mask_image.{h,cc} — mask_image.h:84, Box_mskC parse
mask_image.cc:39, decode :88-125).  The mask's samples go to the
context's device as bytes; a 16-bit mask is big-endian in the file and
its bytes are swapped there (torch has no big-endian dtype).
"""

from __future__ import annotations

from typing import List, Set

import numpy as np
import torch

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, SubError
from ..core.limits import SecurityLimits
from ..boxes.box import FullBox, register_box
from ..boxes.meta import Box_ispe
from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from .item import ImageItem, register_item, DecodingOptions


@register_box("mskC")
class Box_mskC(FullBox):
    """Mask configuration (ref: mask_image.cc:33-56)."""

    def __init__(self, bits_per_pixel: int = 8):
        super().__init__()
        self.bits_per_pixel = bits_per_pixel

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.bits_per_pixel = r.read8()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write8(self.bits_per_pixel)

    def dump_fields(self) -> List[str]:
        return [f"bits_per_pixel: {self.bits_per_pixel}"]


def mask_plane(data, width: int, height: int, bpp: int,
               device) -> torch.Tensor:
    """The (height, width) mask plane on ``device`` from the item's bytes:
    uint8, or uint16 from big-endian pairs swapped on the device."""
    nbytes = width * height * (bpp // 8)
    raw = torch.from_numpy(np.frombuffer(data, np.uint8, nbytes).copy())
    raw = raw.to(device)
    if bpp == 8:
        return raw.view(height, width)
    swapped = raw.view(height, width, 2).flip(-1).contiguous()
    return swapped.view(torch.uint16).view(height, width)


@register_item("mski")
class ImageItem_mask(ImageItem):

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        mskC = self.get_property(Box_mskC)
        ispe = self.get_property(Box_ispe)
        if mskC is None or ispe is None:
            raise HeifError.invalid_input(
                msg="mski item missing mskC/ispe property")
        bpp = mskC.bits_per_pixel
        if bpp not in (8, 16):
            raise HeifError.unsupported(
                SubError.Unsupported_bit_depth,
                f"mask bit depth {bpp} (only 8/16 supported)")
        w, h = ispe.width, ispe.height
        self.ctx.limits.check_image_size(w, h)
        data = self.file.get_item_data(self.item_id)
        if len(data) < w * h * (bpp // 8):
            raise HeifError.eof("mask data too short")
        img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome,
                         self.ctx.limits)
        img.set_plane(Channel.Y, mask_plane(data, w, h, bpp,
                                            self.ctx.device), bpp)
        return img
