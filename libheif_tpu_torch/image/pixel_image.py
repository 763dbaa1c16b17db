"""Planar pixel image model with torch tensor planes.

Counterpart of libheif_tpu/image/pixel_image.py (reference:
libheif/image/pixelimage.{h,cc} — HeifPixelImage pixelimage.h:60).
Planes are 2-D torch tensors on one device: ``torch.uint8`` for depths
up to 8 bits and ``torch.uint16`` above, as in the JAX package.  The
geometric transforms (rotate, mirror, crop, scale, extend) are not part
of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._build import resolve_device
from ..core.error import HeifError, SubError, DecodeWarning
from ..core.limits import SecurityLimits


class Channel:
    """Channel names (reference: heif_channel, heif_image.h)."""

    Y = "Y"
    Cb = "Cb"
    Cr = "Cr"
    R = "R"
    G = "G"
    B = "B"
    Alpha = "Alpha"
    Interleaved = "interleaved"
    Depth = "depth"
    Disparity = "disparity"
    FilterArray = "filter_array"
    Other = "other"


class Colorspace:
    Undefined = "undefined"
    YCbCr = "YCbCr"
    RGB = "RGB"
    Monochrome = "monochrome"
    Nonvisual = "nonvisual"
    FilterArray = "filter_array"   # CFA mosaic (ref: heif_image.h:110)


class Chroma:
    Undefined = "undefined"
    Monochrome = "monochrome"
    C420 = "420"
    C422 = "422"
    C444 = "444"
    InterleavedRGB = "interleaved RGB"
    InterleavedRGBA = "interleaved RGBA"


# component type id (cmpd) → channel name (ref: unc_codec.cc
# map_uncompressed_component_to_channel)
COMPONENT_TYPE_TO_CHANNEL = {
    0: Channel.Y,          # monochrome
    1: Channel.Y,
    2: Channel.Cb,
    3: Channel.Cr,
    4: Channel.R,
    5: Channel.G,
    6: Channel.B,
    7: Channel.Alpha,
    8: Channel.Depth,
    9: Channel.Disparity,
    11: Channel.FilterArray,
}


def chroma_subsampling(chroma: str) -> Tuple[int, int]:
    """(horizontal, vertical) subsampling divisors for Cb/Cr
    (ref: common_utils.h chroma_h/v_subsampling)."""
    if chroma == Chroma.C420:
        return 2, 2
    if chroma == Chroma.C422:
        return 2, 1
    return 1, 1


def subsampled_size(width: int, height: int, channel: str,
                    chroma: str) -> Tuple[int, int]:
    """Channel plane size after chroma subsampling, rounding up
    (ref: common_utils.cc get_subsampled_size_h/v with rounding)."""
    if channel in (Channel.Cb, Channel.Cr):
        sh, sv = chroma_subsampling(chroma)
        return (width + sh - 1) // sh, (height + sv - 1) // sv
    return width, height


@dataclass
class PlaneInfo:
    bit_depth: int = 8
    datatype: str = "unsigned"  # unsigned | signed | float | complex


class PixelImage:
    """A planar image: named channel → 2-D tensor (+ per-plane bit depth)."""

    def __init__(self, width: int, height: int,
                 colorspace: str = Colorspace.Undefined,
                 chroma: str = Chroma.Undefined,
                 limits: Optional[SecurityLimits] = None):
        self.width = width
        self.height = height
        self.colorspace = colorspace
        self.chroma = chroma
        self.limits = limits or SecurityLimits()
        self.planes: Dict[str, torch.Tensor] = {}
        self.plane_info: Dict[str, PlaneInfo] = {}
        self.premultiplied_alpha = False
        self.color_profile_nclx = None   # set by the decode pipeline
        self.color_profile_icc: Optional[bytes] = None
        self.warnings: List[DecodeWarning] = []

    # ---------------------------------------------------------------- planes

    def set_plane(self, channel: str, array: torch.Tensor,
                  bit_depth: Optional[int] = None,
                  datatype: str = "unsigned") -> None:
        if bit_depth is None:
            bit_depth = array.element_size() * 8
        self.planes[channel] = array
        self.plane_info[channel] = PlaneInfo(bit_depth, datatype)

    def has_channel(self, channel: str) -> bool:
        return channel in self.planes

    def channels(self) -> List[str]:
        return list(self.planes.keys())

    def plane(self, channel: str) -> torch.Tensor:
        if channel not in self.planes:
            raise HeifError.usage(SubError.Nonexisting_image_channel_referenced,
                                  f"channel {channel} not present")
        return self.planes[channel]

    def np_plane(self, channel: str) -> np.ndarray:
        return self.plane(channel).cpu().numpy()

    def bit_depth(self, channel: str) -> int:
        if channel not in self.plane_info:
            raise HeifError.usage(SubError.Nonexisting_image_channel_referenced,
                                  f"channel {channel} not present")
        return self.plane_info[channel].bit_depth

    def has_alpha(self) -> bool:
        return (Channel.Alpha in self.planes or
                self.chroma == Chroma.InterleavedRGBA)

    # ------------------------------------------------------------- placement

    def to_device(self, device=None) -> "PixelImage":
        """Move every plane to ``device`` (``None`` means CUDA) in place;
        returns self.  Counterpart of the JAX package's device_put."""
        dev = resolve_device(device)
        for ch in self.planes:
            self.planes[ch] = self.planes[ch].to(dev)
        return self

    def __repr__(self) -> str:
        chans = ",".join(f"{c}{self.plane_info[c].bit_depth}"
                         for c in self.planes)
        return (f"<PixelImage {self.width}x{self.height} {self.colorspace}/"
                f"{self.chroma} [{chans}]>")


def from_numpy_planes(planes: Dict[str, np.ndarray], bits: Dict[str, int],
                      colorspace: str, chroma: str,
                      device=None) -> PixelImage:
    """Build a PixelImage from numpy planes (uint8, or uint16 above 8
    bits) on ``device`` (``None`` means CUDA).  The image size is that of
    the luma (or first full-size) plane."""
    dev = resolve_device(device)
    main = next((c for c in (Channel.Y, Channel.R, Channel.G)
                 if c in planes), next(iter(planes)))
    h, w = planes[main].shape
    img = PixelImage(w, h, colorspace, chroma)
    for ch, arr in planes.items():
        img.set_plane(ch, torch.from_numpy(np.ascontiguousarray(arr)).to(dev),
                      bits[ch])
    return img
