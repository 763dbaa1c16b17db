"""VVC still-image decoder: vvcC and NALs to a PixelImage on the device.

Counterpart of libheif_tpu/codecs/vvc/decoder.py (reference: the vvdec
plugin boundary, libheif/plugins/decoder_vvdec.cc:449,
libheif/codecs/vvc_dec.cc).  It decodes the intra toolset described in
tables.py on the host, as the JAX package does, which has no device
program for VVC: the CABAC parse and ``SliceCoder.run`` (ctu.py), then
``PictureRecon`` (recon.py).  The cropped planes reach the decoder's
device in one pinned copy (``codecs/host_copy.device_planes``), uint8
at 8 bits and uint16 at 10, where the colour conversion of an 8-bit
picture launches ``planes_ycbcr8_to_rgb``.  Refused as in the JAX
package: chroma other than 4:2:0, depths other than 8 and 10, a missing
SPS or PPS, a picture of several slices, and a coded size far beyond
the declared one.

Spans (core/trace.py): ``vvc.decode`` a picture, inside it
``vvc.decode.parse`` (CABAC and the coding tree), ``vvc.decode.recon``
(prediction, dequantisation, transforms) and ``vvc.decode.copy`` (the
host-to-device copy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..._build import resolve_device
from ...core.error import HeifError, SubError
from ...core.trace import span
from ...boxes.codec_cfg import remove_emulation_prevention
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..hevc.decoder import split_length_prefixed
from ..host_copy import device_planes
from . import headers as H
from .cabac import ContextModels, CabacDecoder
from .ctu import SyntaxIO, SliceCoder
from .recon import PictureRecon, chroma_qp_from_luma


def decode_intra_picture(sps: H.SPS, pps: H.PPS, slice_nal: bytes
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The uncropped (Y, Cb, Cr) int32 planes of one intra slice, on the
    host."""
    if sps.chroma_format_idc != 1:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "only 4:2:0 VVC supported")
    if sps.bit_depth not in (8, 10):
        raise HeifError.unsupported(SubError.Unsupported_bit_depth,
                                    "only 8/10-bit VVC supported")
    with span("vvc.decode.parse"):
        sh = H.parse_slice_header(slice_nal, sps, {pps.pps_id: pps})
        rbsp = remove_emulation_prevention(slice_nal[2:])

        ctx = ContextModels(sh.qp)
        dec = CabacDecoder(rbsp, sh.data_offset_bits // 8, len(rbsp), ctx)
        io = SyntaxIO(ctx, dec=dec)
        coder = SliceCoder(sps, pps, sh, io)
        cus = coder.run()

    with span("vvc.decode.recon"):
        recon = PictureRecon(sps.pic_width, sps.pic_height, sps.bit_depth)
        cqp = chroma_qp_from_luma(sh.qp)
        for cu in cus:
            recon.reconstruct_cu_luma(cu, sh.qp)
            recon.reconstruct_tb(cu.x, cu.y, cu.log2w - 1, cu.log2h - 1, 1,
                                 cu.chroma_mode, cu.coeffs_cb, cqp)
            recon.reconstruct_tb(cu.x, cu.y, cu.log2w - 1, cu.log2h - 1, 2,
                                 cu.chroma_mode, cu.coeffs_cr, cqp)
    return tuple(recon.planes)


class VvcDecoder:
    """vvc1 item and vvc1/vvi1 track-sample decoder on ``device``
    (``None``: CUDA, raising without a card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        with span("vvc.decode"):
            return self._decode(config_box, data, declared_size, limits)

    def _decode(self, config_box, data, declared_size, limits):
        if config_box is None:
            raise HeifError.invalid_input(SubError.No_vvcC_box)
        sps = pps = None
        nals = list(config_box.get_header_nals())
        nals += split_length_prefixed(data, config_box.length_size)
        slices = []
        for nal in nals:
            t = H.nal_type(nal)
            if t == H.NAL_SPS:
                sps = H.parse_sps(nal)
            elif t == H.NAL_PPS:
                pps = H.parse_pps(nal)
            elif H.is_slice(t):
                slices.append(nal)
        if sps is None or pps is None:
            raise HeifError.invalid_input(SubError.No_vvcC_box,
                                          "missing VVC SPS/PPS")
        if not slices:
            raise HeifError.invalid_input(msg="no VVC slice NAL")
        if len(slices) != 1:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "multi-slice VVC pictures")
        if limits is not None:
            limits.check_image_size(sps.pic_width, sps.pic_height)
            if declared_size is not None:
                dw, dh = declared_size
                if sps.pic_width * sps.pic_height > \
                        max(4 * dw * dh, dw * dh + (1 << 16)):
                    raise HeifError.security(
                        "coded size much larger than declared size")

        y, cb, cr = decode_intra_picture(sps, pps, slices[0])

        w, h = sps.cropped_size
        l, _, t, _ = sps.conf_win
        y = y[2 * t:2 * t + h, 2 * l:2 * l + w]
        cb = cb[t:t + (h + 1) // 2, l:l + (w + 1) // 2]
        cr = cr[t:t + (h + 1) // 2, l:l + (w + 1) // 2]

        dt = np.uint8 if sps.bit_depth <= 8 else np.uint16
        with span("vvc.decode.copy"):
            planes = device_planes([y.astype(dt), cb.astype(dt),
                                    cr.astype(dt)], self.device)
        img = PixelImage(w, h, Colorspace.YCbCr, Chroma.C420, limits)
        for ch, p in zip((Channel.Y, Channel.Cb, Channel.Cr), planes):
            img.set_plane(ch, p, sps.bit_depth)
        return img
