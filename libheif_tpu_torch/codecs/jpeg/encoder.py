"""Baseline JPEG encoder (ITU-T T.81, Annex K tables).

Counterpart of libheif_tpu/codecs/jpeg/encoder.py (``encode_jpeg`` :109,
``JpegEncoder`` :357; reference: libheif/plugins/encoder_libjpeg.cc).  The
edge padding, level shift, forward DCT and quantiser of every component
plane run on the image's device in one call of ``cuda_fast.fdct_quant``
(the ``jpeg_fdct_quant`` kernel on CUDA, its plain version on the CPU);
the coefficients come to the host in one copy, and the C++ scan
(``native_scan.encode_scan``) emits the Huffman-coded bytes.  The output
is the JAX encoder's byte for byte.  ``_entropy_encode`` is that
package's Python emission, kept as the C++ scan's reference for the
tests.  The encode's parts are the spans ``jpeg.encode.fdct``, ``.copy``,
``.entropy`` and ``.write`` (core/trace.py).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...boxes.meta import Box_ispe
from ...color import convert_image
from ...core import trace
from ...core.error import HeifError, SubError
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..host_copy import host_planes
from ..registry import Encoder as RegistryEncoder, register_encoder
from . import cuda_fast, native_scan
from .bitio import HuffTable, BitWriter
from .tables import (ZIGZAG, STD_LUMA_QUANT, STD_CHROMA_QUANT,
                     quality_scaled_quant, STD_DC_LUMA_BITS, STD_DC_LUMA_VALS,
                     STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS,
                     STD_AC_LUMA_BITS, STD_AC_LUMA_VALS,
                     STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS)


def _size_of(v: int) -> int:
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def _encode_coeff_bits(v: int, size: int) -> int:
    return v if v >= 0 else v + (1 << size) - 1


class _CompPlan:
    def __init__(self, comp_id, h, v, tq, dc_table, ac_table, blocks,
                 blocks_w, blocks_h):
        self.comp_id = comp_id
        self.h = h
        self.v = v
        self.tq = tq
        self.dc_table = dc_table
        self.ac_table = ac_table
        self.blocks = blocks          # (N, 64) zigzag int16
        self.blocks_w = blocks_w
        self.blocks_h = blocks_h


def component_jobs(img: PixelImage):
    """The FDCT jobs of a YCbCr (444/422/420) or monochrome 8-bit image,
    one a component (table 0 for the first, 1 for the others), with their
    sampling factors and the MCU grid: (jobs, sampling, (mcus_w, mcus_h)).
    A component's block grid comes from the MCU grid, not from its plane's
    size (a 4:2:0 chroma plane of an odd width is ceil(W/2) wide, its
    blocks cover mcus_w * 8 columns)."""
    if img.colorspace == Colorspace.Monochrome:
        sampling = [(1, 1)]
        channels = [Channel.Y]
    elif img.colorspace == Colorspace.YCbCr:
        sub = {Chroma.C444: (1, 1), Chroma.C422: (2, 1),
               Chroma.C420: (2, 2)}.get(img.chroma)
        if sub is None:
            raise HeifError.unsupported(
                SubError.Unsupported_color_conversion,
                f"JPEG encode: unsupported chroma {img.chroma}")
        sampling = [sub, (1, 1), (1, 1)]
        channels = [Channel.Y, Channel.Cb, Channel.Cr]
    else:
        raise HeifError.unsupported(
            SubError.Unsupported_color_conversion,
            "JPEG encode requires YCbCr or monochrome input")
    for ch in channels:
        if img.bit_depth(ch) != 8:
            raise HeifError.unsupported(SubError.Unsupported_bit_depth,
                                        "JPEG encode is 8-bit only")
    h_max = max(s[0] for s in sampling)
    v_max = max(s[1] for s in sampling)
    mcus_w = -(-img.width // (8 * h_max))
    mcus_h = -(-img.height // (8 * v_max))
    jobs = []
    for i, (ch, (sh, sv)) in enumerate(zip(channels, sampling)):
        plane = img.plane(ch)
        if plane.dtype != torch.uint8:
            plane = plane.to(torch.uint8)
        jobs.append(cuda_fast.FdctJob(plane, mcus_w * sh, mcus_h * sv,
                                      0 if i == 0 else 1))
    return jobs, sampling, (mcus_w, mcus_h)


def quant_tables(quality: int, n: int, device) -> torch.Tensor:
    """The luma and chroma tables at ``quality`` (natural order), the
    first ``n`` of them, as one (n, 64) int32 tensor on ``device``."""
    tables = [quality_scaled_quant(STD_LUMA_QUANT, quality),
              quality_scaled_quant(STD_CHROMA_QUANT, quality)][:n]
    return torch.from_numpy(np.stack(tables).astype(np.int32)).to(device)


def encode_jpeg(img: PixelImage, quality: int = 75) -> bytes:
    """Encode a YCbCr (444/422/420) or monochrome 8-bit PixelImage, on the
    device its planes lie on."""
    jobs, sampling, (mcus_w, mcus_h) = component_jobs(img)
    luma_q = quality_scaled_quant(STD_LUMA_QUANT, quality)
    chroma_q = quality_scaled_quant(STD_CHROMA_QUANT, quality)

    dc_l = HuffTable(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS)
    ac_l = HuffTable(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS)
    dc_c = HuffTable(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS)
    ac_c = HuffTable(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS)

    quant = quant_tables(quality, min(len(jobs), 2), jobs[0].plane.device)
    with trace.span("jpeg.encode.fdct"):
        coeffs = cuda_fast.fdct_quant(jobs, quant)
    with trace.span("jpeg.encode.copy"):
        host = host_planes([coeffs])[0]

    plans: List[_CompPlan] = []
    first = 0
    for i, ((sh, sv), job) in enumerate(zip(sampling, jobs)):
        n = job.blocks_w * job.blocks_h
        plans.append(_CompPlan(
            comp_id=i + 1, h=sh, v=sv, tq=0 if i == 0 else 1,
            dc_table=dc_l if i == 0 else dc_c,
            ac_table=ac_l if i == 0 else ac_c,
            blocks=host[first:first + n], blocks_w=job.blocks_w,
            blocks_h=job.blocks_h))
        first += n
    with trace.span("jpeg.encode.entropy"):
        entropy = native_scan.encode_scan(plans, mcus_w, mcus_h)
    with trace.span("jpeg.encode.write"):        # headers, scan, EOI
        return _headers(plans, luma_q, chroma_q, (dc_l, ac_l, dc_c, ac_c),
                        img.width, img.height) + entropy + b"\xFF\xD9"


def _headers(plans: List[_CompPlan], luma_q, chroma_q, huff, W: int,
             H: int) -> bytes:
    """SOI, APP0 JFIF, DQT, SOF0, DHT and SOS (encoder.py :196-233)."""
    dc_l, ac_l, dc_c, ac_c = huff
    out = bytearray()
    out += b"\xFF\xD8"                                   # SOI
    # APP0 JFIF
    out += b"\xFF\xE0" + (16).to_bytes(2, "big") + b"JFIF\x00" + \
        bytes([1, 1, 0]) + (1).to_bytes(2, "big") + (1).to_bytes(2, "big") + \
        bytes([0, 0])
    # DQT (zigzag order on the wire)
    for tq, q in ([(0, luma_q)] + ([(1, chroma_q)] if len(plans) > 1 else [])):
        out += b"\xFF\xDB" + (67).to_bytes(2, "big") + bytes([tq])
        out += bytes(int(q[z]) for z in ZIGZAG)
    # SOF0
    ncomp = len(plans)
    out += b"\xFF\xC0" + (8 + 3 * ncomp).to_bytes(2, "big")
    out += bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
    out += bytes([ncomp])
    for p in plans:
        out += bytes([p.comp_id, (p.h << 4) | p.v, p.tq])
    # DHT
    tables = [(0, 0, dc_l), (1, 0, ac_l)]
    if ncomp > 1:
        tables += [(0, 1, dc_c), (1, 1, ac_c)]
    for tc, th, t in tables:
        payload = bytes(t.bits[1:17]) + bytes(t.values)
        out += b"\xFF\xC4" + (3 + len(payload)).to_bytes(2, "big")
        out += bytes([(tc << 4) | th]) + payload
    # SOS
    out += b"\xFF\xDA" + (6 + 2 * ncomp).to_bytes(2, "big") + bytes([ncomp])
    for i, p in enumerate(plans):
        td = 0 if i == 0 else 1
        out += bytes([p.comp_id, (td << 4) | td])
    out += bytes([0, 63, 0])
    return bytes(out)


def _entropy_encode(plans: List[_CompPlan], mcus_w: int,
                    mcus_h: int) -> bytes:
    """The Python scan emission (encoder.py :301-326): the plain reference
    of ``native_scan.encode_scan``; the encoder itself does not call it."""
    w = BitWriter()
    preds = {p.comp_id: 0 for p in plans}
    interleaved = len(plans) > 1
    if not interleaved:
        p = plans[0]
        order = [(p, i) for i in range(p.blocks_h * p.blocks_w)]
    else:
        order = []
        for my in range(mcus_h):
            for mx in range(mcus_w):
                for p in plans:
                    for by in range(p.v):
                        for bx in range(p.h):
                            idx = (my * p.v + by) * p.blocks_w + \
                                (mx * p.h + bx)
                            order.append((p, idx))
    for p, idx in order:
        _encode_block(w, p, p.blocks[idx], preds)
    w.pad_to_byte()
    return w.getvalue()


def _encode_block(w: BitWriter, p: _CompPlan, block: np.ndarray, preds):
    dc = int(block[0])
    diff = dc - preds[p.comp_id]
    preds[p.comp_id] = dc
    s = _size_of(diff)
    ln, code = p.dc_table.enc[s]
    w.put_bits(code, ln)
    if s:
        w.put_bits(_encode_coeff_bits(diff, s), s)
    run = 0
    # find last nonzero
    nz = np.nonzero(block[1:])[0]
    last = (nz[-1] + 1) if len(nz) else 0
    for k in range(1, last + 1):
        v = int(block[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            ln, code = p.ac_table.enc[0xF0]          # ZRL
            w.put_bits(code, ln)
            run -= 16
        s = _size_of(v)
        ln, code = p.ac_table.enc[(run << 4) | s]
        w.put_bits(code, ln)
        w.put_bits(_encode_coeff_bits(v, s), s)
        run = 0
    if last < 63:
        ln, code = p.ac_table.enc[0x00]              # EOB
        w.put_bits(code, ln)


class JpegEncoder(RegistryEncoder):
    """Registry encoder for `jpeg` items (ref: encoder_libjpeg.cc)."""

    id = "tpu-jpeg"
    format = "jpeg"
    priority = 100
    lossy_supported = True
    lossless_supported = False

    def parameters(self):
        return [{"name": "quality", "type": "integer", "minimum": 1,
                 "maximum": 100, "default": 75}]

    def encode_single_image(self, img: PixelImage, options=None):
        quality = getattr(options, "quality", 75) if options else 75
        if img.colorspace not in (Colorspace.YCbCr, Colorspace.Monochrome):
            img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                                device=next(iter(img.planes.values()))
                                .device)
        data = encode_jpeg(img, quality=quality)
        return data, None, [(Box_ispe(img.width, img.height), False)]


def _register():
    register_encoder(JpegEncoder())


_register()
