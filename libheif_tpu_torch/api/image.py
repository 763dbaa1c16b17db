"""Pixel-image API (ref: api/libheif/heif_image.h, 29 fns); counterpart
of libheif_tpu/api/image.py.

C-named shims over libheif_tpu_torch.image.pixel_image.PixelImage, whose
planes are torch tensors on one device (ref: HeifPixelImage
pixelimage.h:60).  The plane contract: ``heif_image_get_plane`` and
``heif_image_get_plane_readonly`` return the plane tensor itself, on the
image's device, with its own stride (the C (data, stride) pair), so a
write through it reaches the image, as through the C pointer; no getter
copies a plane to the host (call ``.cpu()`` for that).  The geometry
functions (crop, scale, rotate, mirror, extract, extend) run as torch ops
on the planes' device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .._build import resolve_device
from ..core.error import HeifError
from ..image.pixel_image import (PixelImage, Channel, Colorspace, Chroma,
                                 _moved)

heif_colorspace = Colorspace
heif_chroma = Chroma
heif_channel = Channel


def heif_image_create(width: int, height: int, colorspace: str,
                      chroma: str, limits=None, device=None) -> PixelImage:
    """An image without planes whose ``add_plane`` allocates on
    ``device`` (None: CUDA, raising without a card)."""
    return PixelImage(width, height, colorspace, chroma, limits,
                      resolve_device(device))


def heif_image_release(img: PixelImage) -> None:
    pass  # GC-managed


def heif_image_get_colorspace(img: PixelImage) -> str:
    return img.colorspace


def heif_image_get_chroma_format(img: PixelImage) -> str:
    return img.chroma


def heif_image_get_width(img: PixelImage,
                         channel: Optional[str] = None) -> int:
    if channel is None:
        return img.width
    return img.plane_size(channel)[0]


def heif_image_get_height(img: PixelImage,
                          channel: Optional[str] = None) -> int:
    if channel is None:
        return img.height
    return img.plane_size(channel)[1]


def heif_image_get_primary_width(img: PixelImage) -> int:
    return img.width


def heif_image_get_primary_height(img: PixelImage) -> int:
    return img.height


def heif_image_has_channel(img: PixelImage, channel: str) -> bool:
    return img.has_channel(channel)


def heif_image_list_channels(img: PixelImage) -> List[str]:
    return img.channels()


def heif_image_add_plane(img: PixelImage, channel: str, width: int,
                         height: int, bit_depth: int) -> None:
    img.add_plane(channel, width, height, bit_depth)


def heif_image_get_plane(img: PixelImage, channel: str) -> torch.Tensor:
    """The writable plane: the image's own tensor, on its device, its
    stride the C stride (ref: heif_image.h heif_image_get_plane)."""
    return img.plane(channel)


def heif_image_get_plane_readonly(img: PixelImage,
                                  channel: str) -> torch.Tensor:
    """The plane tensor itself, on the image's device (torch has no
    read-only tensors: the caller does not write through it)."""
    return img.plane(channel)


def heif_image_get_bits_per_pixel(img: PixelImage, channel: str) -> int:
    """Storage bits (8/16/32) (ref: heif_image.h get_bits_per_pixel)."""
    d = img.bit_depth(channel)
    return 8 if d <= 8 else (16 if d <= 16 else 32)


def heif_image_get_bits_per_pixel_range(img: PixelImage,
                                        channel: str) -> int:
    """Value-range bits (the coded bit depth)."""
    return img.bit_depth(channel)


def heif_image_crop(img: PixelImage, left: int, top: int, right: int,
                    bottom: int) -> PixelImage:
    """(ref: heif_image.h heif_image_crop: crop amounts per edge)."""
    w = img.width - left - right
    h = img.height - top - bottom
    if w <= 0 or h <= 0:
        raise HeifError.usage(msg="crop leaves empty image")
    return img.crop(left, top, w, h)


def heif_image_scale_image(img: PixelImage, new_width: int,
                           new_height: int, options=None) -> PixelImage:
    return img.scale_nearest(new_width, new_height)


def heif_image_rotate_ccw(img: PixelImage, degrees: int) -> PixelImage:
    return img.rotate_ccw(degrees)


def heif_image_mirror_horizontal(img: PixelImage) -> PixelImage:
    return img.mirror("H")


def heif_image_mirror_vertical(img: PixelImage) -> PixelImage:
    return img.mirror("V")


def heif_image_extend_padding_to_size(img: PixelImage, min_width: int,
                                      min_height: int) -> None:
    if img.width >= min_width and img.height >= min_height:
        return
    ext = img.extend(max(img.width, min_width),
                     max(img.height, min_height))
    img.width, img.height = ext.width, ext.height
    for ch in ext.channels():
        img.set_plane(ch, ext.plane(ch), ext.bit_depth(ch))


def heif_image_set_premultiplied_alpha(img: PixelImage,
                                       is_premultiplied: bool) -> None:
    img.premultiplied_alpha = bool(is_premultiplied)


def heif_image_is_premultiplied_alpha(img: PixelImage) -> bool:
    return bool(getattr(img, "premultiplied_alpha", False))


# ---------------------------------------------------------- color profiles

def heif_image_set_raw_color_profile(img: PixelImage, profile_type: str,
                                     profile_data: bytes) -> None:
    """profile_type: 'prof' or 'rICC' (ref: heif_color.h raw profile)."""
    img.color_profile_icc = bytes(profile_data)
    img.color_profile_icc_type = profile_type


def heif_image_get_raw_color_profile_size(img: PixelImage) -> int:
    p = img.color_profile_icc
    return len(p) if p else 0


def heif_image_get_raw_color_profile(img: PixelImage) -> Optional[bytes]:
    return img.color_profile_icc


def heif_image_get_color_profile_type(img: PixelImage) -> Optional[str]:
    if img.color_profile_icc:
        return getattr(img, "color_profile_icc_type", "prof")
    if img.color_profile_nclx is not None:
        return "nclx"
    return None


def heif_image_set_nclx_color_profile(img: PixelImage, nclx) -> None:
    img.color_profile_nclx = nclx


def heif_image_get_nclx_color_profile(img: PixelImage):
    return img.color_profile_nclx


# ------------------------------------------------- content light / pasp

def heif_image_set_pixel_aspect_ratio(img: PixelImage, aspect_h: int,
                                      aspect_v: int) -> None:
    img.pixel_aspect_ratio = (aspect_h, aspect_v)


def heif_image_get_pixel_aspect_ratio(img: PixelImage) -> Tuple[int, int]:
    return getattr(img, "pixel_aspect_ratio", (1, 1))


def heif_image_has_content_light_level(img: PixelImage) -> bool:
    return getattr(img, "clli", None) is not None


def heif_image_get_content_light_level(img: PixelImage):
    return getattr(img, "clli", None)


def heif_image_set_content_light_level(img: PixelImage, clli) -> None:
    img.clli = clli


def heif_image_has_mastering_display_colour_volume(img) -> bool:
    return getattr(img, "mdcv", None) is not None


def heif_image_get_mastering_display_colour_volume(img):
    return getattr(img, "mdcv", None)


def heif_image_set_mastering_display_colour_volume(img, mdcv) -> None:
    img.mdcv = mdcv


def heif_image_get_decoding_warnings(img: PixelImage) -> List:
    return list(getattr(img, "warnings", []))


def heif_image_get_plane2(img: PixelImage, channel: str) -> torch.Tensor:
    """size_t-stride variant; the tensor carries its own stride
    (ref: heif_image.h:278)."""
    return heif_image_get_plane(img, channel)


def heif_image_get_plane_readonly2(img: PixelImage,
                                   channel: str) -> torch.Tensor:
    return heif_image_get_plane_readonly(img, channel)


def heif_image_add_plane_safe(img: PixelImage, channel: str,
                              width: int, height: int, bit_depth: int,
                              limits=None) -> None:
    """add_plane with an explicit security-limit check before
    allocation (ref: heif_image.h:387)."""
    if limits is not None:
        limits.check_image_size(width, height)
    img.add_plane(channel, width, height, bit_depth)


def heif_image_extend_to_size_fill_with_zero(img: PixelImage,
                                             width: int,
                                             height: int) -> None:
    """Grow every plane to the (subsampled) target size, zero-filling
    new samples on the plane's device (ref: heif_image.h
    extend_to_size)."""
    for ch in list(img.planes):
        pl = img.plane(ch)
        ph, pw = pl.shape
        sx = -(-img.width // pw) if pw else 1
        sy = -(-img.height // ph) if ph else 1
        fw = -(-width // sx)
        fh = -(-height // sy)
        if fw <= pw and fh <= ph:
            continue
        out = _moved(lambda a: torch.nn.functional.pad(
            a, (0, max(fw, pw) - pw, 0, max(fh, ph) - ph)), pl)
        img.set_plane(ch, out, img.bit_depth(ch))
    img.width = max(img.width, width)
    img.height = max(img.height, height)


def heif_image_extract_area(img: PixelImage, x0: int, y0: int,
                            w: int, h: int, limits=None) -> PixelImage:
    """Crop a rectangle into a new image, on the planes' device (ref:
    heif_image.h:226)."""
    if limits is not None:
        limits.check_image_size(w, h)
    if x0 + w > img.width or y0 + h > img.height:
        raise HeifError.invalid_input(msg="extract area out of bounds")
    out = PixelImage(w, h, img.colorspace, img.chroma, device=img.device)
    for ch in list(img.planes):
        pl = img.plane(ch)
        ph, pw = pl.shape
        sx = -(-img.width // pw) if pw else 1
        sy = -(-img.height // ph) if ph else 1
        cx, cy = x0 // sx, y0 // sy
        cw, chh = -(-w // sx), -(-h // sy)
        out.set_plane(ch, _moved(lambda a: a[cy:cy + chh, cx:cx + cw], pl),
                      img.bit_depth(ch))
    return out


def heif_image_add_decoding_warning(img: PixelImage, err) -> None:
    """Attach a non-fatal warning to the image
    (ref: heif_image.h add_decoding_warning; pixelimage warnings)."""
    if not hasattr(img, "decoding_warnings"):
        img.decoding_warnings = []
    img.decoding_warnings.append(err)
