"""Colour conversion operations on torch planes.

Counterpart of libheif_tpu/color/ops.py (reference:
libheif/color-conversion/ — yuv2rgb.cc, monochrome.cc, alpha.cc,
hdr_sdr.cc, rgb2rgb.cc; op registry colorconversion.cc:225-269).
``ALL_OPS`` lists the JAX package's 13 ops in its order and with its
costs, so the pipeline search picks the same chain.  Every op runs as
torch on the image's device (YCbCrToRGB through the planes_ycbcr8_to_rgb
kernel where it can); none moves planes to the host.

Arithmetic is float32 with the JAX package's operation order and
rounding (half to even, as jnp.round; the JAX module's docstring says
half away from zero, its code does not).  Divisions by a scalar go
through ``cuda_fast.true_div``; nothing here reaches a matmul or a
convolution, so TF32 never applies.  The integer stages (MonoToYCbCr,
FlattenAlpha, ChromaResample by nearest, bilinear up and average down,
BayerToRGB) are exact against the JAX ops: BayerToRGB takes its box sums
in int32, which equals the JAX f32 convolution wherever that sum stays
below 2**24 (every pattern up to 8x8 at 16 bits).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.error import HeifError, SubError
from ..image.pixel_image import (
    PixelImage, Channel, Colorspace, Chroma, _moved, subsampled_size)
from ..codecs.unc import cuda_fast
from .nclx import get_kr_kb
from .state import ColorState


class ColorConversionOptions:
    """(ref: heif_color_conversion_options, heif_color.h).  The alpha
    composition mode selects between DropAlpha and FlattenAlpha in the
    search; backgrounds are 16-bit (R, G, B), shifted to the image's
    depth by FlattenAlpha."""

    NEAREST = "nearest-neighbor"
    BILINEAR = "bilinear"
    AVERAGE = "average"
    SHARP_YUV = "sharp-yuv"

    # alpha composition modes (ref: heif_alpha_composition_mode,
    # heif_color.h:74)
    ALPHA_NONE = "none"
    ALPHA_SOLID = "solid-color"
    ALPHA_CHECKERBOARD = "checkerboard"

    def __init__(self, chroma_upsampling: str = BILINEAR,
                 chroma_downsampling: str = AVERAGE,
                 alpha_composition_mode: str = ALPHA_NONE,
                 background_rgb=(0xFFFF, 0xFFFF, 0xFFFF),
                 secondary_background_rgb=(0x6666, 0x6666, 0x6666),
                 checkerboard_square_size: int = 16):
        self.chroma_upsampling = chroma_upsampling
        self.chroma_downsampling = chroma_downsampling
        self.alpha_composition_mode = alpha_composition_mode
        self.background_rgb = background_rgb
        self.secondary_background_rgb = secondary_background_rgb
        self.checkerboard_square_size = checkerboard_square_size


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


def _downsample(plane_f32: torch.Tensor, factor_x: int, factor_y: int,
                method: str) -> torch.Tensor:
    """Chroma downsampling by integer factors (average or nearest); the
    average pads the plane by edge replication to whole blocks."""
    a = plane_f32
    h, w = a.shape
    if factor_x == 1 and factor_y == 1:
        return a
    if method == ColorConversionOptions.NEAREST:
        return a[::factor_y, ::factor_x]
    hh = h + (-h) % factor_y
    ww = w + (-w) % factor_x
    if (hh, ww) != (h, w):
        ys = torch.clamp(torch.arange(hh, device=a.device), max=h - 1)
        xs = torch.clamp(torch.arange(ww, device=a.device), max=w - 1)
        a = a[ys[:, None], xs[None, :]]
    return a.reshape(hh // factor_y, factor_y, ww // factor_x,
                     factor_x).mean(dim=(1, 3))


def _sharp_downsample(plane_f32: torch.Tensor, th: int, tw: int,
                      iters: int = 4) -> torch.Tensor:
    """'Sharp' chroma downsampling (ref: rgb2yuv_sharp.cc): Richardson
    iterations on min ||upsample(C_sub) - C||^2, each a bilinear upsample,
    the residual and its average."""
    a = plane_f32
    h, w = a.shape
    fx = max(1, round(w / tw))
    fy = max(1, round(h / th))
    sub = _downsample(a, fx, fy, ColorConversionOptions.AVERAGE)[:th, :tw]
    for _ in range(iters):
        up = _upsample(sub, h, w, ColorConversionOptions.BILINEAR)
        sub = sub + _downsample(a - up, fx, fy,
                                ColorConversionOptions.AVERAGE)[:th, :tw]
    return sub


def _box_sum(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Zero-padded centred (kh, kw) box sum of an int32 plane, exact, as
    separable shifted adds."""
    h, w = x.shape
    rh, rw = kh // 2, kw // 2
    p = torch.nn.functional.pad(x, (rw, rw, rh, rh))
    rows = p[:, :w].clone()
    for j in range(1, kw):
        rows += p[:, j:j + w]
    out = rows[:h].clone()
    for i in range(1, kh):
        out += rows[i:i + h]
    return out


def _device(img: PixelImage) -> torch.device:
    return next(iter(img.planes.values())).device


class ColorOp:
    """Base op (ref: ColorConversionOperation colorconversion.h:78)."""

    cost = 4

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
    """(ref: rgb2yuv.cc Op_RGB_to_YCbCr): the forward H.273 matrix in
    f32, then chroma downsampling."""

    cost = 6

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

    def apply(self, img, inp, outp, options):
        bits = inp.bits_per_pixel
        maxval = (1 << bits) - 1
        r = img.plane(Channel.R).to(torch.float32)
        g = img.plane(Channel.G).to(torch.float32)
        b = img.plane(Channel.B).to(torch.float32)

        kr, kb = get_kr_kb(outp.matrix_coefficients, outp.color_primaries)
        yf = kr * r + (1 - kr - kb) * g + kb * b
        cbf = cuda_fast.true_div(b - yf, 2 * (1 - kb))
        crf = cuda_fast.true_div(r - yf, 2 * (1 - kr))
        half = float(1 << (bits - 1))
        if outp.full_range:
            y = yf
            cb = cbf + half
            cr = crf + half
        else:
            y = yf * (219.0 / 255.0) + (16 << (bits - 8))
            cb = cbf * (224.0 / 255.0) + half
            cr = crf * (224.0 / 255.0) + half

        fx = 2 if outp.chroma in (Chroma.C420, Chroma.C422) else 1
        fy = 2 if outp.chroma == Chroma.C420 else 1
        cb = _downsample(cb, fx, fy, options.chroma_downsampling)
        cr = _downsample(cr, fx, fy, options.chroma_downsampling)

        out = self._base_output(img, outp)
        dt = _out_dtype(bits)
        out.set_plane(Channel.Y, _round_clip(y, maxval).to(dt), bits)
        out.set_plane(Channel.Cb, _round_clip(cb, maxval).to(dt), bits)
        out.set_plane(Channel.Cr, _round_clip(cr, maxval).to(dt), bits)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out


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
    """(ref: monochrome.cc Op_mono_to_YCbCr420): Y as it is, mid-grey
    chroma at the target's subsampled size."""

    cost = 2

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.Monochrome:
            return None
        if target.colorspace != Colorspace.YCbCr:
            return None
        chroma = target.chroma if target.chroma in (
            Chroma.C420, Chroma.C422, Chroma.C444) else Chroma.C420
        return inp.with_(colorspace=Colorspace.YCbCr, chroma=chroma)

    def apply(self, img, inp, outp, options):
        out = self._base_output(img, outp)
        y = img.plane(Channel.Y)
        bits = img.bit_depth(Channel.Y)
        out.set_plane(Channel.Y, y, bits)
        cw, chh = subsampled_size(img.width, img.height, Channel.Cb,
                                  outp.chroma)
        c = torch.full((chh, cw), 1 << (bits - 1), dtype=_out_dtype(bits),
                       device=y.device)
        out.set_plane(Channel.Cb, c, bits)
        out.set_plane(Channel.Cr, c, bits)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out


class ChromaResample(ColorOp):
    """YCbCr chroma format change (ref: chroma_sampling.cc ops): up by
    ``chroma_upsampling``, down by nearest, average or sharp-yuv."""

    cost = 4

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.YCbCr:
            return None
        if target.colorspace not in (Colorspace.YCbCr, Colorspace.Undefined):
            return None
        if target.chroma in (Chroma.Undefined, inp.chroma) or \
                target.chroma not in (Chroma.C420, Chroma.C422, Chroma.C444):
            return None
        return inp.with_(chroma=target.chroma)

    def apply(self, img, inp, outp, options):
        out = self._base_output(img, outp)
        bits = img.bit_depth(Channel.Y)
        maxval = (1 << bits) - 1
        dt = _out_dtype(bits)
        out.set_plane(Channel.Y, img.plane(Channel.Y), bits)
        tw, th = subsampled_size(img.width, img.height, Channel.Cb,
                                 outp.chroma)
        for ch in (Channel.Cb, Channel.Cr):
            a = img.plane(ch)
            h, w = a.shape
            if tw >= w and th >= h:
                res = _upsample(a, th, tw, options.chroma_upsampling)
            elif options.chroma_downsampling == \
                    ColorConversionOptions.SHARP_YUV:
                res = _sharp_downsample(a.to(torch.float32), th, tw)
            else:
                fx = max(1, round(w / tw))
                fy = max(1, round(h / th))
                res = _downsample(a.to(torch.float32), fx, fy,
                                  options.chroma_downsampling)[:th, :tw]
            # nearest upsampling keeps the plane's integer dtype
            out.set_plane(ch, _round_clip(res.to(torch.float32),
                                          maxval).to(dt), bits)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out


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
    (ref: alpha.cc Op_flatten_alpha_plane): solid-color or checkerboard
    composition, RGB 4:4:4 input.

    out = (c*a + bkg*(a_max - a)) >> alpha_bits in int64 (c*a reaches
    65535**2 at 16 bits), with the 16-bit background shifted to the
    image's depth; the planes stay on their device."""

    cost = 2

    def enabled(self, options):
        return options is not None and options.alpha_composition_mode != \
            ColorConversionOptions.ALPHA_NONE

    def output_state(self, inp, target):
        if not inp.has_alpha or target.has_alpha:
            return None
        if inp.colorspace != Colorspace.RGB or inp.chroma != Chroma.C444:
            return None
        return inp.with_(has_alpha=False)

    def apply(self, img, inp, outp, options):
        bits = img.bit_depth(Channel.R)
        abits = img.bit_depth(Channel.Alpha)
        amax = (1 << abits) - 1
        a = img.plane(Channel.Alpha).to(torch.int64)
        h, w = a.shape
        checker = (options.alpha_composition_mode ==
                   ColorConversionOptions.ALPHA_CHECKERBOARD and
                   options.checkerboard_square_size > 0)
        if checker:
            s = options.checkerboard_square_size
            yy = torch.arange(h, device=a.device)[:, None] // s
            xx = torch.arange(w, device=a.device)[None, :] // s
            parity = (yy + xx) & 1
        out = self._base_output(img, outp)
        dt = _out_dtype(bits)
        for i, ch in enumerate((Channel.R, Channel.G, Channel.B)):
            c = img.plane(ch).to(torch.int64)
            bkg = options.background_rgb[i] >> (16 - bits)
            if checker:
                bkg2 = options.secondary_background_rgb[i] >> (16 - bits)
                # parity-0 (top-left) square gets the SECONDARY
                # background (ref: alpha.cc `bkg = parity ? bkg1 : bkg2`)
                bkg = torch.where(parity == 0, bkg2, bkg)
            res = (c * a + bkg * (amax - a)) >> abits
            out.set_plane(ch, res.to(dt), bits)
        return out


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
    """RGB → monochrome via luma, matrix 6 (used for mask/aux encode
    paths)."""

    cost = 6

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.RGB:
            return None
        if target.colorspace != Colorspace.Monochrome:
            return None
        return inp.with_(colorspace=Colorspace.Monochrome,
                         chroma=Chroma.Monochrome)

    def apply(self, img, inp, outp, options):
        bits = inp.bits_per_pixel
        maxval = (1 << bits) - 1
        r = img.plane(Channel.R).to(torch.float32)
        g = img.plane(Channel.G).to(torch.float32)
        b = img.plane(Channel.B).to(torch.float32)
        kr, kb = get_kr_kb(6, inp.color_primaries)
        y = kr * r + (1 - kr - kb) * g + kb * b
        out = self._base_output(img, outp)
        out.set_plane(Channel.Y, _round_clip(y, maxval).to(_out_dtype(bits)),
                      bits)
        if img.has_channel(Channel.Alpha):
            out.set_plane(Channel.Alpha, img.plane(Channel.Alpha),
                          img.bit_depth(Channel.Alpha))
        return out


class BayerToRGB(ColorOp):
    """CFA mosaic → RGB bilinear demosaic (ref: bayer_bilinear.cc
    Op_bayer_bilinear_to_RGB24_32).

    For each pixel and missing channel, the mean of every same-channel
    cell within a (2·ph−1)×(2·pw−1) window, border pixels counting only
    in-image cells; native cells pass through.  Per channel: a 0/1 mask
    tiled from the pattern, num and den as exact int32 box sums of
    plane·mask and mask, then num / max(den, 1) in f32 (not a
    convolution: cuDNN's default TF32 would round 12- and 16-bit
    samples)."""

    cost = 11   # SpeedCosts_Unoptimized in the reference

    def output_state(self, inp, target):
        if inp.colorspace != Colorspace.FilterArray:
            return None
        if target.colorspace not in (Colorspace.RGB, Colorspace.Undefined):
            return None
        return inp.with_(colorspace=Colorspace.RGB, chroma=Chroma.C444)

    def apply(self, img, inp, outp, options):
        pattern = img.bayer_pattern
        if pattern is None:
            raise HeifError.invalid_input(
                SubError.Unspecified,
                "filter-array image carries no CFA pattern (cpat)")
        ph, pw = pattern.pattern_height, pattern.pattern_width
        cells = pattern.channels
        if any(c not in (Channel.R, Channel.G, Channel.B) for c in cells):
            raise HeifError.unsupported(
                SubError.Unsupported_data_version,
                "Bayer pattern contains component types that we "
                "currently cannot convert to RGB")
        bits = img.bit_depth(Channel.FilterArray)
        maxval = (1 << bits) - 1
        a = img.plane(Channel.FilterArray).to(torch.int32)
        h, w = a.shape
        dev = a.device
        # tile per-channel masks over the image
        yy = torch.arange(h, device=dev) % ph
        xx = torch.arange(w, device=dev) % pw
        cell_ch = torch.tensor(
            [{Channel.R: 0, Channel.G: 1, Channel.B: 2}[c] for c in cells],
            dtype=torch.int32, device=dev)
        pix_ch = cell_ch[yy[:, None] * pw + xx[None, :]]    # (h, w)

        kh, kw = 2 * ph - 1, 2 * pw - 1
        out = self._base_output(img, outp)
        dt = _out_dtype(bits)
        for ci, ch in enumerate((Channel.R, Channel.G, Channel.B)):
            mask = pix_ch == ci
            m32 = mask.to(torch.int32)
            num = _box_sum(a * m32, kh, kw).to(torch.float32)
            den = torch.clamp(_box_sum(m32, kh, kw), min=1).to(torch.float32)
            plane = torch.where(mask, a.to(torch.float32), num / den)
            out.set_plane(ch, _round_clip(plane, maxval).to(dt), bits)
        return out


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
