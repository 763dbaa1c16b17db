"""Colour conversion operations on torch planes.

Counterpart of libheif_tpu/color/ops.py (reference:
libheif/color-conversion/ — yuv2rgb.cc, monochrome.cc, alpha.cc,
hdr_sdr.cc, rgb2rgb.cc; op registry colorconversion.cc:225-269).
``ALL_OPS`` lists the JAX package's 13 ops in its order and with its
costs, so the pipeline search picks the same chain.  Seven are ported
(YCbCrToRGB, MonoToRGB, BitDepthConvert, DropAlpha, AddAlpha and the two
interleave ops); the other six keep their state transitions for the
search and are marked ``ported = False``, and a conversion whose chain
needs one raises Unsupported_color_conversion naming it.

Arithmetic is float32 with the JAX package's operation order and
rounding (half to even, as jnp.round; the JAX module's docstring says
half away from zero, its code does not).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..image.pixel_image import (
    PixelImage, Channel, Colorspace, Chroma, _moved)
from ..codecs.unc import cuda_fast
from .nclx import get_kr_kb
from .state import ColorState


class ColorConversionOptions:
    """(ref: heif_color_conversion_options, heif_color.h).  The ported
    ops read chroma upsampling; the alpha composition mode selects
    between DropAlpha and FlattenAlpha in the search.  Downsampling and
    the composition backgrounds wait with the ops that read them."""

    NEAREST = "nearest-neighbor"
    BILINEAR = "bilinear"

    # alpha composition modes (ref: heif_alpha_composition_mode,
    # heif_color.h:74)
    ALPHA_NONE = "none"
    ALPHA_SOLID = "solid-color"
    ALPHA_CHECKERBOARD = "checkerboard"

    def __init__(self, chroma_upsampling: str = BILINEAR,
                 alpha_composition_mode: str = ALPHA_NONE):
        self.chroma_upsampling = chroma_upsampling
        self.alpha_composition_mode = alpha_composition_mode


def _round_clip(x: torch.Tensor, maxval: int) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, maxval)


def _out_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else torch.uint16


def _upsample(plane: torch.Tensor, out_h: int, out_w: int,
              method: str) -> torch.Tensor:
    """Chroma upsampling to (out_h, out_w) (ref: chroma up in
    yuv2rgb.cc / chroma_sampling.cc).  Nearest keeps the plane's dtype;
    bilinear returns float32."""
    a = plane
    h, w = a.shape
    dev = a.device
    if method == ColorConversionOptions.NEAREST or (h == out_h and w == out_w):
        ys = (torch.arange(out_h, device=dev) * h) // out_h
        xs = (torch.arange(out_w, device=dev) * w) // out_w
        return _moved(lambda p: p[ys[:, None], xs[None, :]], a)
    # bilinear: 2x kernels (3a+b)/4 at half-pel positions
    af = a.to(torch.float32)
    if out_w == 2 * w or (w * 2 - out_w in (0, 1)):
        left = torch.cat([af[:, :1], af[:, :-1]], dim=1)
        right = torch.cat([af[:, 1:], af[:, -1:]], dim=1)
        even = (3 * af + left) / 4
        odd = (3 * af + right) / 4
        af = torch.stack([even, odd], dim=-1).reshape(h, 2 * w)[:, :out_w]
    elif out_w != w:
        af = af[:, (torch.arange(out_w, device=dev) * w) // out_w]
    h2 = af.shape[0]
    if out_h == 2 * h2 or (2 * h2 - out_h in (0, 1)):
        top = torch.cat([af[:1], af[:-1]], dim=0)
        bottom = torch.cat([af[1:], af[-1:]], dim=0)
        even = (3 * af + top) / 4
        odd = (3 * af + bottom) / 4
        af = torch.stack([even, odd], dim=1) \
            .reshape(2 * h2, af.shape[1])[:out_h]
    elif out_h != h2:
        af = af[(torch.arange(out_h, device=dev) * h2) // out_h]
    return af


def _device(img: PixelImage) -> torch.device:
    return next(iter(img.planes.values())).device


class ColorOp:
    """Base op (ref: ColorConversionOperation colorconversion.h:78)."""

    cost = 4
    ported = True

    def enabled(self, options: Optional[ColorConversionOptions]) -> bool:
        """Whether this op participates in pipeline search under the
        given conversion options."""
        return True

    def output_state(self, inp: ColorState,
                     target: ColorState) -> Optional[ColorState]:
        raise NotImplementedError

    def apply(self, img: PixelImage, inp: ColorState, outp: ColorState,
              options: ColorConversionOptions) -> PixelImage:
        raise NotImplementedError

    def _base_output(self, img: PixelImage, outp: ColorState) -> PixelImage:
        out = PixelImage(img.width, img.height, outp.colorspace, outp.chroma,
                         img.limits)
        out.premultiplied_alpha = img.premultiplied_alpha
        out.color_profile_nclx = img.color_profile_nclx
        out.color_profile_icc = img.color_profile_icc
        out.warnings = list(img.warnings)
        return out


class YCbCrToRGB(ColorOp):
    """(ref: yuv2rgb.cc Op_YCbCr_to_RGB)."""

    cost = 6

    # None: the planes_ycbcr8_to_rgb kernel for CUDA planes, the matrix
    # path for CPU planes.  True/False force the choice (tests, and the
    # plain path that chip_smoke.py holds the kernel against).
    USE_KERNEL: Optional[bool] = None

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.YCbCr:
            return None
        if target.colorspace not in (Colorspace.RGB, Colorspace.Undefined):
            return None
        return inp.with_(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                         matrix_coefficients=0, full_range=True)

    def apply(self, img, inp, outp, options):
        bits = inp.bits_per_pixel
        maxval = (1 << bits) - 1

        fast = self._apply_kernel(img, inp, outp, options)
        if fast is not None:
            return fast

        y = img.plane(Channel.Y).to(torch.float32)
        h, w = y.shape

        if img.has_channel(Channel.Cb):
            cb = _upsample(img.plane(Channel.Cb), h, w,
                           options.chroma_upsampling).to(torch.float32)
            cr = _upsample(img.plane(Channel.Cr), h, w,
                           options.chroma_upsampling).to(torch.float32)
        else:
            cb = cr = torch.full((h, w), float(1 << (bits - 1)),
                                 dtype=torch.float32, device=y.device)

        if inp.matrix_coefficients == 0:
            # identity: GBR (ref: yuv2rgb identity path)
            r, g, b = cr, y, cb
        else:
            kr, kb = get_kr_kb(inp.matrix_coefficients, inp.color_primaries)
            half = float(1 << (bits - 1))
            if inp.full_range:
                yf = y
                scale_c = 1.0
            else:
                yf = (y - (16 << (bits - 8))) * (255.0 / 219.0)
                scale_c = 255.0 / 224.0
            cbf = (cb - half) * scale_c
            crf = (cr - half) * scale_c
            r = yf + 2 * (1 - kr) * crf
            b = yf + 2 * (1 - kb) * cbf
            g = cuda_fast.true_div(yf - kr * r - kb * b, 1 - kr - kb)

        out = self._base_output(img, outp)
        dt = _out_dtype(bits)
        out.set_plane(Channel.R, _round_clip(r, maxval).to(dt), bits)
        out.set_plane(Channel.G, _round_clip(g, maxval).to(dt), bits)
        out.set_plane(Channel.B, _round_clip(b, maxval).to(dt), bits)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out

    def _apply_kernel(self, img, inp, outp, options):
        """8-bit non-identity YCbCr with nearest or bilinear upsampling:
        one planes_ycbcr8_to_rgb kernel (upsample + H.273 matrix + pack).
        Returns None outside that envelope, as the JAX op's Pallas path
        does (ops.py:242-279)."""
        use = YCbCrToRGB.USE_KERNEL
        if use is None:
            use = img.plane(Channel.Y).device.type == "cuda"
        if not use:
            return None
        if (inp.bits_per_pixel != 8 or inp.matrix_coefficients == 0
                or not img.has_channel(Channel.Cb)):
            return None
        if options.chroma_upsampling not in (
                ColorConversionOptions.BILINEAR,
                ColorConversionOptions.NEAREST):
            return None
        kr, kb = get_kr_kb(inp.matrix_coefficients, inp.color_primaries)
        rgb = cuda_fast.ycbcr8_planes_to_rgb(
            img.plane(Channel.Y).contiguous(),
            img.plane(Channel.Cb).contiguous(),
            img.plane(Channel.Cr).contiguous(),
            kr=float(kr), kb=float(kb), full_range=bool(inp.full_range),
            upsampling=options.chroma_upsampling)
        out = self._base_output(img, outp)
        out.set_plane(Channel.R, rgb[0], 8)
        out.set_plane(Channel.G, rgb[1], 8)
        out.set_plane(Channel.B, rgb[2], 8)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out


class RGBToYCbCr(ColorOp):
    """(ref: rgb2yuv.cc Op_RGB_to_YCbCr).  Not ported yet."""

    cost = 6
    ported = False

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.RGB or inp.chroma not in (
                Chroma.C444, Chroma.Undefined):
            return None
        if target.colorspace not in (Colorspace.YCbCr, Colorspace.Undefined):
            return None
        chroma = target.chroma if target.chroma in (
            Chroma.C420, Chroma.C422, Chroma.C444) else Chroma.C420
        mc = target.matrix_coefficients or 6
        return inp.with_(colorspace=Colorspace.YCbCr, chroma=chroma,
                         matrix_coefficients=mc,
                         full_range=target.full_range)


class MonoToRGB(ColorOp):
    """(ref: monochrome.cc Op_mono_to_RGB24_32)."""

    cost = 2

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.Monochrome:
            return None
        if target.colorspace not in (Colorspace.RGB, Colorspace.Undefined):
            return None
        return inp.with_(colorspace=Colorspace.RGB, chroma=Chroma.C444)

    def apply(self, img, inp, outp, options):
        out = self._base_output(img, outp)
        y = img.plane(Channel.Y)
        bits = img.bit_depth(Channel.Y)
        for ch in (Channel.R, Channel.G, Channel.B):
            out.set_plane(ch, y, bits)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out


class MonoToYCbCr(ColorOp):
    """(ref: monochrome.cc Op_mono_to_YCbCr420).  Not ported yet."""

    cost = 2
    ported = False

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.Monochrome:
            return None
        if target.colorspace != Colorspace.YCbCr:
            return None
        chroma = target.chroma if target.chroma in (
            Chroma.C420, Chroma.C422, Chroma.C444) else Chroma.C420
        return inp.with_(colorspace=Colorspace.YCbCr, chroma=chroma)


class ChromaResample(ColorOp):
    """YCbCr chroma format change (ref: chroma_sampling.cc ops).  Not
    ported yet."""

    cost = 4
    ported = False

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.YCbCr:
            return None
        if target.colorspace not in (Colorspace.YCbCr, Colorspace.Undefined):
            return None
        if target.chroma in (Chroma.Undefined, inp.chroma) or \
                target.chroma not in (Chroma.C420, Chroma.C422, Chroma.C444):
            return None
        return inp.with_(chroma=target.chroma)


class BitDepthConvert(ColorOp):
    """Scale all planes to a different bit depth (ref: hdr_sdr.cc
    Op_to_sdr_planes / Op_to_hdr_planes): rounding right shift down,
    bit replication up, in int64 (the JAX op's uint32 never wraps
    for these depths)."""

    cost = 2

    def output_state(self, inp, target):
        if not target.bits_per_pixel or \
                target.bits_per_pixel == inp.bits_per_pixel:
            return None
        if inp.colorspace == Colorspace.Undefined:
            return None
        return inp.with_(bits_per_pixel=target.bits_per_pixel)

    def apply(self, img, inp, outp, options):
        out = self._base_output(img, outp)
        tbits = outp.bits_per_pixel
        dt = _out_dtype(tbits)
        for ch in img.channels():
            a = img.plane(ch)
            sbits = img.bit_depth(ch)
            if sbits == tbits:
                out.set_plane(ch, a, tbits)
                continue
            a64 = a.to(torch.int64)
            if sbits > tbits:
                shift = sbits - tbits
                v = torch.clamp((a64 + (1 << (shift - 1))) >> shift,
                                max=(1 << tbits) - 1)
            else:
                shift = tbits - sbits
                # bit replication to fill the new LSBs
                v = a64 << shift
                fill = shift
                while fill > 0:
                    take = min(sbits, fill)
                    v = v | ((a64 >> (sbits - take)) << (fill - take))
                    fill -= take
            out.set_plane(ch, v.to(dt), tbits)
        return out


class DropAlpha(ColorOp):
    """(ref: alpha.cc Op_drop_alpha_plane)."""

    cost = 1

    def enabled(self, options):
        # when a composition mode is requested, FlattenAlpha takes over
        return options is None or options.alpha_composition_mode == \
            ColorConversionOptions.ALPHA_NONE

    def output_state(self, inp, target):
        if not inp.has_alpha or target.has_alpha:
            return None
        return inp.with_(has_alpha=False)

    def apply(self, img, inp, outp, options):
        out = self._base_output(img, outp)
        for ch in img.channels():
            if ch != Channel.Alpha:
                out.set_plane(ch, img.plane(ch), img.bit_depth(ch))
        return out


class FlattenAlpha(ColorOp):
    """Composite the alpha plane over a background and drop it
    (ref: alpha.cc Op_flatten_alpha_plane).  Not ported yet."""

    cost = 2
    ported = False

    def enabled(self, options):
        return options is not None and options.alpha_composition_mode != \
            ColorConversionOptions.ALPHA_NONE

    def output_state(self, inp, target):
        if not inp.has_alpha or target.has_alpha:
            return None
        if inp.colorspace != Colorspace.RGB or inp.chroma != Chroma.C444:
            return None
        return inp.with_(has_alpha=False)


class AddAlpha(ColorOp):
    """Add an opaque alpha plane (ref: alpha.cc)."""

    cost = 1

    def output_state(self, inp, target):
        if inp.has_alpha or not target.has_alpha:
            return None
        if inp.colorspace == Colorspace.Undefined:
            return None
        return inp.with_(has_alpha=True)

    def apply(self, img, inp, outp, options):
        out = self._base_output(img, outp)
        for ch in img.channels():
            out.set_plane(ch, img.plane(ch), img.bit_depth(ch))
        bits = inp.bits_per_pixel
        out.set_plane(Channel.Alpha,
                      torch.full((img.height, img.width), (1 << bits) - 1,
                                 dtype=_out_dtype(bits), device=_device(img)),
                      bits)
        return out


class RGBToMono(ColorOp):
    """RGB → monochrome via luma (used for mask/aux encode paths).  Not
    ported yet."""

    cost = 6
    ported = False

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.RGB:
            return None
        if target.colorspace != Colorspace.Monochrome:
            return None
        return inp.with_(colorspace=Colorspace.Monochrome,
                         chroma=Chroma.Monochrome)


class BayerToRGB(ColorOp):
    """CFA mosaic → RGB bilinear demosaic (ref: bayer_bilinear.cc
    Op_bayer_bilinear_to_RGB24_32).  Not ported yet."""

    cost = 11   # SpeedCosts_Unoptimized in the reference
    ported = False

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.FilterArray:
            return None
        if target.colorspace not in (Colorspace.RGB, Colorspace.Undefined):
            return None
        return inp.with_(colorspace=Colorspace.RGB, chroma=Chroma.C444)


class PlanarToInterleavedRGB(ColorOp):
    """Planar RGB 4:4:4 → packed interleaved plane (ref: rgb2rgb.cc
    Op_RGB_to_RGB24_32 / Op_RGB_to_RRGGBB).

    8-bit targets pack RGB(A) bytes; >8-bit targets pack RRGGBB(AA) as
    uint16 in native order.  The interleaved plane has shape
    (h, w·ncomp)."""

    cost = 1   # Trivial in the reference cost model

    TARGETS = (Chroma.InterleavedRGB, Chroma.InterleavedRGBA)

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.RGB or inp.chroma != Chroma.C444:
            return None
        if target.chroma not in self.TARGETS:
            return None
        has_alpha = target.chroma == Chroma.InterleavedRGBA
        return inp.with_(chroma=target.chroma, has_alpha=has_alpha)

    def apply(self, img, inp, outp, options):
        bits = img.bit_depth(Channel.R)
        dt = _out_dtype(bits)
        maxval = (1 << bits) - 1
        planes = [img.plane(c).to(dt)
                  for c in (Channel.R, Channel.G, Channel.B)]
        if outp.chroma == Chroma.InterleavedRGBA:
            if img.has_channel(Channel.Alpha):
                a = img.plane(Channel.Alpha)
                if img.bit_depth(Channel.Alpha) != bits:
                    shift = bits - img.bit_depth(Channel.Alpha)
                    a32 = a.to(torch.int32)
                    a = (a32 << shift) if shift > 0 else (a32 >> -shift)
                planes.append(a.to(dt))
            else:
                planes.append(torch.full_like(planes[0], maxval))
        h, w = planes[0].shape
        n = len(planes)
        inter = _moved(lambda *p: torch.stack(p, dim=-1).reshape(h, w * n),
                       *planes)
        out = self._base_output(img, outp)
        out.set_plane(Channel.Interleaved, inter, bits)
        return out


class InterleavedToPlanarRGB(ColorOp):
    """Packed interleaved RGB(A) plane → planar RGB 4:4:4
    (ref: rgb2rgb.cc Op_RGB24_32_to_RGB)."""

    cost = 1

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.RGB or \
                inp.chroma not in PlanarToInterleavedRGB.TARGETS:
            return None
        if target.chroma in PlanarToInterleavedRGB.TARGETS:
            return None
        has_alpha = inp.chroma == Chroma.InterleavedRGBA
        return inp.with_(chroma=Chroma.C444, has_alpha=has_alpha)

    def apply(self, img, inp, outp, options):
        bits = img.bit_depth(Channel.Interleaved)
        n = 4 if inp.chroma == Chroma.InterleavedRGBA else 3
        a = img.plane(Channel.Interleaved)
        h = a.shape[0]
        w = a.shape[1] // n
        out = self._base_output(img, outp)
        for i, ch in enumerate((Channel.R, Channel.G, Channel.B)):
            out.set_plane(ch, _moved(lambda p: p.reshape(h, w, n)[:, :, i],
                                     a), bits)
        if n == 4:
            out.set_plane(Channel.Alpha, _moved(
                lambda p: p.reshape(h, w, n)[:, :, 3], a), bits)
        return out


ALL_OPS: List[ColorOp] = [
    YCbCrToRGB(), RGBToYCbCr(), MonoToRGB(), MonoToYCbCr(),
    ChromaResample(), BitDepthConvert(), DropAlpha(), FlattenAlpha(),
    AddAlpha(), RGBToMono(), BayerToRGB(), PlanarToInterleavedRGB(),
    InterleavedToPlanarRGB(),
]
