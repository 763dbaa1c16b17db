"""JPEG 2000 items: codestream components <-> PixelImage planes.

Counterpart of libheif_tpu/codecs/j2k/codec.py (ref: plugins/
decoder_openjpeg.cc:519, plugins/encoder_openjpeg.cc; jpeg2000_dec.cc
Decoder_JPEG2000).  The decoder is a class taking a device, as AvcDecoder
is, registered as ``tpu-j2k`` for ``jpeg2000`` (JAX codec.py:26):
``J2KImageDecoder(device)`` decodes a `j2k1` item or tile on the host and brings its planes to the
device in one copy (host_copy.device_planes), components of several
depths included.  The two registry encoders, ``jpeg2000`` and ``htj2k``,
convert on the image's device where they must (interleaved to RGB 4:4:4;
YCbCr that is not 4:4:4 to RGB 4:4:4, as the JAX encoder does), take the
planes to the host in one copy (host_copy.host_planes) and code there.
The parts are the spans ``j2k.decode`` (with ``.parse``, ``.t1``,
``.dwt``, ``.copy``) and ``j2k.encode`` (``.copy``, ``.dwt``, ``.t1``,
``.write``; core/trace.py).
"""

from __future__ import annotations

import numpy as np

from ..._build import resolve_device
from ...boxes.j2k import Box_cdef, Box_j2kH
from ...boxes.meta import Box_ispe
from ...color import convert_image
from ...core import trace
from ...core.error import HeifError, SubError
from ...image.pixel_image import Channel, Chroma, Colorspace, PixelImage
from ..host_copy import device_planes, host_planes
from ..registry import (BuiltinDecoder, Encoder, register_decoder,
                        register_encoder)
from .decoder import decode_codestream
from .encoder import encode_codestream


def _np_dtype(depth: int):
    return np.uint8 if depth <= 8 else np.uint16


class J2KImageDecoder:
    """`j2k1` item and tile decoder on ``device`` (``None``: CUDA,
    raising without a card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        with trace.span("j2k.decode"):
            return self._decode(config_box, data, declared_size, limits)

    def _decode(self, config_box, data, declared_size, limits):
        if limits is not None and declared_size:
            limits.check_image_size(*declared_size)
        planes, cs = decode_codestream(data)
        siz = cs.siz
        w = siz.xsiz - siz.xosiz
        h = siz.ysiz - siz.yosiz
        if limits is not None:
            limits.check_image_size(w, h)
        ncomp = len(planes)
        depths = [c.depth for c in siz.comps]

        # channel roles from the j2kH cdef box when present
        alpha_comp = None
        if config_box is not None:
            for ch in config_box.get_children(Box_cdef):
                for (ci, ty, _asoc) in ch.channels:
                    if ty in (1, 2) and ci < ncomp:
                        alpha_comp = ci

        sub = [(siz.comps[i].xr, siz.comps[i].yr) for i in range(ncomp)]
        if ncomp == 1:
            space, chroma = Colorspace.Monochrome, Chroma.Monochrome
            roles = [(Channel.Y, 0)]
        elif ncomp >= 3 and sub[0] == sub[1] == sub[2] == (1, 1):
            space, chroma = Colorspace.RGB, Chroma.C444
            roles = [(Channel.R, 0), (Channel.G, 1), (Channel.B, 2)]
            if ncomp >= 4:
                roles.append((Channel.Alpha, alpha_comp
                              if alpha_comp is not None else 3))
        elif ncomp >= 3:
            # subsampled: treat as YCbCr
            chroma = {(1, 1): Chroma.C444, (2, 1): Chroma.C422,
                      (2, 2): Chroma.C420}.get(sub[1])
            if chroma is None or sub[1] != sub[2] or sub[0] != (1, 1):
                raise HeifError.unsupported(
                    SubError.Unsupported_color_conversion,
                    f"unsupported J2K sampling {sub}")
            space = Colorspace.YCbCr
            roles = [(Channel.Y, 0), (Channel.Cb, 1), (Channel.Cr, 2)]
        else:
            raise HeifError.unsupported(
                SubError.Unsupported_color_conversion,
                f"J2K with {ncomp} components")
        arrays = [planes[i].astype(_np_dtype(depths[i])) for _, i in roles]
        with trace.span("j2k.decode.copy"):
            tensors = device_planes(arrays, self.device)
        img = PixelImage(w, h, space, chroma, limits)
        for (ch, i), t in zip(roles, tensors):
            img.set_plane(ch, t, depths[i])
        return img


class J2KEncoder_Registry(Encoder):
    """Registry encoder for `j2k1` items (lossless 5/3 by default,
    9/7 when lossy quality requested)."""

    id = "tpu-j2k"
    format = "jpeg2000"
    priority = 100
    lossy_supported = True
    lossless_supported = True
    htj2k = False

    def parameters(self):
        return [
            {"name": "quality", "type": "integer", "minimum": 1,
             "maximum": 100, "default": 70},
            {"name": "lossless", "type": "boolean", "default": True},
        ]

    def encode_single_image(self, img: PixelImage, options=None):
        with trace.span("j2k.encode"):
            return self._encode(img, options)

    def _encode(self, img: PixelImage, options):
        lossless = bool(getattr(options, "lossless", True)) if options \
            else True
        quality = getattr(options, "quality", 70) if options else 70
        device = next(iter(img.planes.values())).device

        if img.has_channel(Channel.Interleaved):
            img = convert_image(img, Colorspace.RGB, Chroma.C444,
                                device=device)

        cdef = Box_cdef()
        if img.colorspace == Colorspace.Monochrome or \
                (img.has_channel(Channel.Y) and not img.has_channel(Channel.Cb)):
            chans = [Channel.Y]
            cdef.channels = [(0, 0, 1)]
        elif img.colorspace == Colorspace.RGB:
            chans = [Channel.R, Channel.G, Channel.B]
            cdef.set_channels_rgb(False)
        elif img.colorspace == Colorspace.YCbCr:
            chans = [Channel.Y, Channel.Cb, Channel.Cr]
            cdef.channels = [(0, 0, 1), (1, 0, 2), (2, 0, 3)]
            if img.chroma != Chroma.C444:
                img = convert_image(img, Colorspace.RGB, Chroma.C444,
                                    device=device)
                chans = [Channel.R, Channel.G, Channel.B]
                cdef.set_channels_rgb(False)
        else:
            raise HeifError.unsupported(
                SubError.Unsupported_color_conversion,
                f"J2K encode from {img.colorspace}")
        depth = img.bit_depth(chans[0])
        with trace.span("j2k.encode.copy"):
            planes = [a.astype(np.int32) for a in
                      host_planes([img.plane(c) for c in chans])]
        data = encode_codestream(planes, depth=depth, reversible=lossless,
                                 quality=quality, htj2k=self.htj2k)
        j2kh = Box_j2kH()
        j2kh.children.append(cdef)
        return data, j2kh, [(Box_ispe(img.width, img.height), False)]


class HTJ2KEncoder_Registry(J2KEncoder_Registry):
    """Registry encoder for the `htj2k` compression format: same j2k1
    container path, HT (15444-15) cleanup-pass block coding.  Reference
    analog: Encoder_HTJ2K (jpeg2000_enc.h:84) backed by OpenJPH
    (plugins/encoder_openjph.cc)."""

    id = "tpu-htj2k"
    format = "htj2k"
    htj2k = True


def register():
    register_decoder(BuiltinDecoder("tpu-j2k", "jpeg2000", J2KImageDecoder))
    register_encoder(J2KEncoder_Registry())
    register_encoder(HTJ2KEncoder_Registry())
