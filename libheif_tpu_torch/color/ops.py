"""Colour conversion operations on torch planes.

Counterpart of libheif_tpu/color/ops.py (reference:
libheif/color-conversion/yuv2rgb.cc; op registry colorconversion.cc:225-269).
Only YCbCr→RGB is ported so far; ``ALL_OPS`` holds the ops this package
has, and a conversion that needs another op raises
Unsupported_color_conversion from the pipeline search.

Arithmetic is float32 with the JAX package's operation order and
rounding (half to even, as jnp.round; the JAX module's docstring says
half away from zero, its code does not).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..codecs.unc import cuda_fast
from .nclx import get_kr_kb
from .state import ColorState


class ColorConversionOptions:
    """(ref: heif_color_conversion_options, heif_color.h).  Only chroma
    upsampling is read by the ops this package has."""

    NEAREST = "nearest-neighbor"
    BILINEAR = "bilinear"

    def __init__(self, chroma_upsampling: str = BILINEAR):
        self.chroma_upsampling = chroma_upsampling


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
        return a[ys[:, None], xs[None, :]]
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


class ColorOp:
    """Base op (ref: ColorConversionOperation colorconversion.h:78)."""

    cost = 4

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


ALL_OPS = [YCbCrToRGB()]
