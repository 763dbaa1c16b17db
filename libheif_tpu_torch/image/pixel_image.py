"""Planar pixel image model with torch tensor planes.

Counterpart of libheif_tpu/image/pixel_image.py (reference:
libheif/image/pixelimage.{h,cc} — HeifPixelImage pixelimage.h:60).
Planes are 2-D torch tensors on one device: ``torch.uint8`` for depths
up to 8 bits and ``torch.uint16`` above, as in the JAX package.  The
geometric transforms (rotate, mirror, crop, scale, extend) and the grid
paste (``copy_into``) run as torch ops on the planes' device; each
returns contiguous planes, so a cropped or rotated image can go straight
to a kernel that takes contiguous tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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


class BayerPattern:
    """CFA mosaic pattern: pattern_height×pattern_width grid of channel
    names + per-cell gains (ref: BayerPattern image_description.h:59,
    Box_cpat unc_boxes.h)."""

    def __init__(self, pattern_width: int, pattern_height: int,
                 channels, gains=None):
        self.pattern_width = pattern_width
        self.pattern_height = pattern_height
        self.channels = list(channels)       # row-major, len w*h
        self.gains = list(gains) if gains is not None \
            else [1.0] * (pattern_width * pattern_height)

    @staticmethod
    def rggb():
        return BayerPattern(2, 2, [Channel.R, Channel.G,
                                   Channel.G, Channel.B])


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


# PyTorch implements few operators for uint16/uint32 (on the CPU not even
# flip); data movement runs on a signed view of the same bits instead.
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _moved(fn: Callable[..., torch.Tensor],
           *arrays: torch.Tensor) -> torch.Tensor:
    """``fn(*arrays)`` for an ``fn`` that only moves samples of arrays of
    one dtype (flip, rot90, slice, gather, stack, pad with zeros), made
    contiguous."""
    dtype = arrays[0].dtype
    view = _SIGNED_VIEW.get(dtype)
    if view is None:
        return fn(*arrays).contiguous()
    return fn(*(a.view(view) for a in arrays)).contiguous().view(dtype)


def _dtype_for(bit_depth: int, datatype: str = "unsigned") -> torch.dtype:
    """The sample type of a plane (JAX PixelImage._dtype_for)."""
    if datatype == "float":
        return torch.float32 if bit_depth <= 32 else torch.float64
    if datatype == "signed":
        return torch.int8 if bit_depth <= 8 else (
            torch.int16 if bit_depth <= 16 else torch.int32)
    return torch.uint8 if bit_depth <= 8 else (
        torch.uint16 if bit_depth <= 16 else torch.uint32)


@dataclass
class PlaneInfo:
    bit_depth: int = 8
    datatype: str = "unsigned"  # unsigned | signed | float | complex


class PixelImage:
    """A planar image: named channel → 2-D tensor (+ per-plane bit depth).

    ``device`` is where ``add_plane`` allocates when it is not given one
    (``heif_image_create`` records the resolved device here); None leaves
    the choice to each ``add_plane`` call, whose own None means CUDA."""

    def __init__(self, width: int, height: int,
                 colorspace: str = Colorspace.Undefined,
                 chroma: str = Chroma.Undefined,
                 limits: Optional[SecurityLimits] = None, device=None):
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
        # CFA mosaic pattern of a FilterArray image: BayerPattern or None
        # (ref: BayerPattern image_description.h:59, cpat unc_boxes.h)
        self.bayer_pattern: Optional[BayerPattern] = None
        self.device = device

    # ---------------------------------------------------------------- planes

    def add_plane(self, channel: str, width: Optional[int] = None,
                  height: Optional[int] = None, bit_depth: int = 8,
                  datatype: str = "unsigned", device=None) -> None:
        """Allocate a zeroed ``width`` x ``height`` plane (the channel's
        subsampled size where either is None, as in JAX pixel_image.py:
        168-180) of ``datatype`` samples (unsigned, signed or float) under
        the security budget (ref: HeifPixelImage::add_plane / alloc under
        memory budget), on ``device``, else on the image's device, else
        CUDA."""
        if width is None or height is None:
            width, height = subsampled_size(self.width, self.height,
                                            channel, self.chroma)
        self.limits.check_image_size(width, height)
        dtype = _dtype_for(bit_depth, datatype)
        nbytes = width * height * dtype.itemsize
        self.limits.check_block_size(nbytes, f"plane {channel}")
        dev = resolve_device(self.device if device is None else device)
        self.planes[channel] = torch.zeros((height, width), dtype=dtype,
                                           device=dev)
        self.plane_info[channel] = PlaneInfo(bit_depth, datatype)

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
        """A host copy of the plane (a copy for a plane on the card:
        writes into it do not reach the image)."""
        return self.plane(channel).cpu().numpy()

    def plane_size(self, channel: str) -> Tuple[int, int]:
        """(width, height) of the channel's plane."""
        h, w = self.plane(channel).shape[:2]
        return w, h

    def bit_depth(self, channel: str) -> int:
        if channel not in self.plane_info:
            raise HeifError.usage(SubError.Nonexisting_image_channel_referenced,
                                  f"channel {channel} not present")
        return self.plane_info[channel].bit_depth

    def has_alpha(self) -> bool:
        return (Channel.Alpha in self.planes or
                self.chroma == Chroma.InterleavedRGBA)

    def add_warning(self, err: HeifError) -> None:
        self.warnings.append(DecodeWarning(err))

    # ------------------------------------------------------------ transforms
    # (ref: pixelimage.h:277-297 rotate_ccw/mirror/crop ops)

    def rotate_ccw(self, degrees: int) -> "PixelImage":
        if degrees % 360 == 0:
            return self
        k = (degrees // 90) % 4
        w, h = (self.width, self.height) if k % 2 == 0 \
            else (self.height, self.width)
        out = self._like(w, h)
        for ch, arr in self.planes.items():
            out.planes[ch] = _moved(
                lambda a: torch.rot90(a, k, dims=(0, 1)), arr)
            out.plane_info[ch] = self.plane_info[ch]
        return out

    def mirror(self, direction: str) -> "PixelImage":
        """direction: 'vertical' mirrors left-right (over the vertical
        axis), 'horizontal' mirrors top-bottom — matching Box_imir."""
        axis = 1 if direction == "vertical" else 0
        out = self._like(self.width, self.height)
        for ch, arr in self.planes.items():
            out.planes[ch] = _moved(lambda a: torch.flip(a, dims=(axis,)),
                                    arr)
            out.plane_info[ch] = self.plane_info[ch]
        return out

    def crop(self, left: int, top: int, width: int,
             height: int) -> "PixelImage":
        """The planes are copied, not viewed: chroma of a subsampled image
        starts at left // sh, top // sv and spans the rounded-up size."""
        if left < 0 or top < 0 or left + width > self.width or \
                top + height > self.height:
            raise HeifError.invalid_input(
                SubError.Invalid_clean_aperture,
                f"crop [{left},{top},{width}x{height}] outside image "
                f"{self.width}x{self.height}")
        out = self._like(width, height)
        for ch, arr in self.planes.items():
            sh = sv = 1
            if ch in (Channel.Cb, Channel.Cr):
                sh, sv = chroma_subsampling(self.chroma)
            l, t = left // sh, top // sv
            w = (width + sh - 1) // sh
            h = (height + sv - 1) // sv
            out.planes[ch] = _moved(lambda a: a[t:t + h, l:l + w], arr)
            out.plane_info[ch] = self.plane_info[ch]
        return out

    def scale_nearest(self, new_width: int, new_height: int) -> "PixelImage":
        """Nearest-neighbour scale (ref: pixelimage.cc scale_nearest_neighbor)."""
        out = self._like(new_width, new_height)
        for ch, arr in self.planes.items():
            ph, pw = arr.shape
            tw, th = subsampled_size(new_width, new_height, ch, self.chroma)
            ys = (torch.arange(th, device=arr.device) * ph) // th
            xs = (torch.arange(tw, device=arr.device) * pw) // tw
            out.planes[ch] = _moved(lambda a: a[ys[:, None], xs[None, :]],
                                    arr)
            out.plane_info[ch] = self.plane_info[ch]
        return out

    def extend(self, new_width: int, new_height: int,
               mode: str = "edge") -> "PixelImage":
        """Pad to a larger canvas replicating the border, or with zeros
        for any other mode (ref: pixelimage.cc extend_to_size_with_zero /
        edge replication)."""
        out = self._like(new_width, new_height)
        for ch, arr in self.planes.items():
            tw, th = subsampled_size(new_width, new_height, ch, self.chroma)
            ph, pw = arr.shape
            if th < ph or tw < pw:
                raise ValueError(f"extend to {tw}x{th} from {pw}x{ph}")
            if mode == "edge":
                # replicate: index with the coordinates clamped to the plane
                ys = torch.clamp(torch.arange(th, device=arr.device),
                                 max=ph - 1)
                xs = torch.clamp(torch.arange(tw, device=arr.device),
                                 max=pw - 1)
                out.planes[ch] = _moved(
                    lambda a: a[ys[:, None], xs[None, :]], arr)
            else:
                out.planes[ch] = _moved(lambda a: torch.nn.functional.pad(
                    a, (0, tw - pw, 0, th - ph)), arr)
            out.plane_info[ch] = self.plane_info[ch]
        return out

    def copy_into(self, other: "PixelImage", x0: int, y0: int) -> None:
        """Paste `other` at (x0,y0), clipped to this image's planes, in
        place on their device — the grid tile composition primitive (ref:
        pixelimage.cc copy_image / grid.cc paste).  Chroma offsets are
        x0 // sh, y0 // sv."""
        for ch, src in other.planes.items():
            if ch not in self.planes:
                continue
            dst = self.planes[ch]
            sh, sv = 1, 1
            if ch in (Channel.Cb, Channel.Cr):
                sh, sv = chroma_subsampling(self.chroma)
            x, y = x0 // sh, y0 // sv
            h = min(src.shape[0], dst.shape[0] - y)
            w = min(src.shape[1], dst.shape[1] - x)
            if h > 0 and w > 0:
                dst[y:y + h, x:x + w].copy_(src[:h, :w])

    def _like(self, width: int, height: int) -> "PixelImage":
        out = PixelImage(width, height, self.colorspace, self.chroma,
                         self.limits, self.device)
        out.premultiplied_alpha = self.premultiplied_alpha
        out.color_profile_nclx = self.color_profile_nclx
        out.color_profile_icc = self.color_profile_icc
        out.warnings = list(self.warnings)
        out.bayer_pattern = self.bayer_pattern
        return out

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


def image_on_device(img: PixelImage, device) -> PixelImage:
    """``img``, or where a plane lies on another device than ``device``
    (resolved already), a copy of it with every plane on ``device``; the
    caller's image is left as it is."""
    if all(p.device == device for p in img.planes.values()):
        return img
    out = img._like(img.width, img.height)
    for ch, p in img.planes.items():
        out.planes[ch] = p.to(device)
        out.plane_info[ch] = img.plane_info[ch]
    return out


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
