"""Color conversion state descriptor.

Re-designed equivalent of the reference's ColorState (reference:
libheif/color-conversion/colorconversion.h:31 — ColorState
{colorspace, chroma, has_alpha, bits_per_pixel, nclx}).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from .nclx import NclxProfile


@dataclass(frozen=True)
class ColorState:
    colorspace: str = Colorspace.Undefined
    chroma: str = Chroma.Undefined
    has_alpha: bool = False
    bits_per_pixel: int = 8
    matrix_coefficients: int = 6
    color_primaries: int = 2
    full_range: bool = True

    @staticmethod
    def of(img: PixelImage) -> "ColorState":
        nclx = img.color_profile_nclx
        main = Channel.Y if img.has_channel(Channel.Y) else (
            Channel.R if img.has_channel(Channel.R) else
            (img.channels()[0] if img.channels() else Channel.Y))
        bpp = img.bit_depth(main) if img.channels() else 8
        return ColorState(
            colorspace=img.colorspace,
            chroma=img.chroma,
            has_alpha=img.has_alpha(),   # incl. interleaved RGBA
            bits_per_pixel=bpp,
            matrix_coefficients=(nclx.matrix_coefficients if nclx else 6),
            color_primaries=(nclx.color_primaries if nclx else 2),
            full_range=(nclx.full_range_flag if nclx else True),
        )

    def with_(self, **kw) -> "ColorState":
        return replace(self, **kw)

    def matches(self, other: "ColorState") -> bool:
        """Loose match used as the pipeline target test: undefined
        fields in `other` act as wildcards."""
        if other.colorspace != Colorspace.Undefined and \
                self.colorspace != other.colorspace:
            return False
        if other.chroma != Chroma.Undefined and self.chroma != other.chroma:
            return False
        if self.has_alpha != other.has_alpha:
            return False
        if other.bits_per_pixel and self.bits_per_pixel != other.bits_per_pixel:
            return False
        return True
