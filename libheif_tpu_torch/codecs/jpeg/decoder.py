"""Baseline/extended-sequential JPEG decoder (ITU-T T.81) on the device.

Counterpart of libheif_tpu/codecs/jpeg/decoder.py (``JpegParser`` :86-497,
``decode_jpeg`` :621-700, ``JpegDecoder`` :703; reference:
libheif/plugins/decoder_libjpeg.cc, image-items/jpeg.cc).  The marker
parse runs on the host in Python and each scan's Huffman chain in host
C++ (host/jpeg_scan.cc through native_scan), the Python scan below
staying as the plain reference and as the path for exotic table ids, as
in the JAX package.  Everything after the coefficients -- dequantisation,
de-zigzag, the islow IDCT, the level shift and the placement of the
blocks in the planes -- is one launch of ``jpeg_dequant_idct``
(cuda_fast) for every component of every frame of a batch, writing
straight into the output planes on the decoder's device.

Output is a YCbCr (or monochrome) PixelImage at the frame's native
chroma, BT.601 full range; the colour pipeline converts it to RGB as for
every other codec.  Progressive, lossless, hierarchical and arithmetic
coded streams raise ``Unsupported``, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._build import resolve_device
from ...color.nclx import NclxProfile
from ...core.error import HeifError, SubError
from ...core.trace import span
from ...image.pixel_image import (PixelImage, Channel, Colorspace, Chroma,
                                  chroma_subsampling)
from . import native_scan
from .bitio import HuffTable, BitReader, unstuff, extend
from .cuda_fast import Job, dequant_idct
from .tables import ZIGZAG

# marker codes
SOF_MARKERS = {0xC0: "baseline", 0xC1: "extended"}
UNSUPPORTED_SOF = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "diff-seq",
                   0xC6: "diff-prog", 0xC7: "diff-lossless",
                   0xC9: "arith-seq", 0xCA: "arith-prog", 0xCB: "arith-ll",
                   0xCD: "arith-diff-seq", 0xCE: "arith-diff-prog",
                   0xCF: "arith-diff-ll"}


@dataclass
class JpegComponent:
    comp_id: int
    h: int
    v: int
    tq: int                      # quant table id
    # filled during scan decode
    blocks_w: int = 0
    blocks_h: int = 0
    coeffs: Optional[np.ndarray] = None   # (blocks_h*blocks_w, 64) zigzag


@dataclass
class JpegFrame:
    precision: int
    width: int
    height: int
    components: List[JpegComponent] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    restart_interval: int = 0
    quant: Dict[int, np.ndarray] = field(default_factory=dict)   # natural order
    huff_dc: Dict[int, HuffTable] = field(default_factory=dict)
    huff_ac: Dict[int, HuffTable] = field(default_factory=dict)

    @property
    def h_max(self):
        return max(c.h for c in self.components)

    @property
    def v_max(self):
        return max(c.v for c in self.components)


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


_DHT_CACHE = {}


class JpegParser:
    """Marker-level parse + per-scan entropy decode driver.  ``native``
    False runs every scan through the Python scan (the plain
    reference)."""

    def __init__(self, data, native: bool = True):
        self.data = data
        self.native = native
        self.frame: Optional[JpegFrame] = None

    def parse(self) -> JpegFrame:
        data = self.data
        n = len(data)
        if n < 2 or data[0] != 0xFF or data[1] != 0xD8:
            raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                          "not a JPEG stream (missing SOI)")
        pos = 2
        frame = None
        while pos + 4 <= n:
            if data[pos] != 0xFF:
                pos += 1
                continue
            marker = data[pos + 1]
            if marker == 0xFF:       # fill byte
                pos += 1
                continue
            pos += 2
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                continue             # no payload
            if marker == 0xD9:       # EOI
                break
            if pos + 2 > n:
                raise HeifError.eof("truncated JPEG marker segment")
            seglen = _u16(data, pos)
            if seglen < 2 or pos + seglen > n:
                raise HeifError.eof("JPEG segment length out of range")
            body = data[pos + 2:pos + seglen]
            pos += seglen

            if marker in SOF_MARKERS:
                frame = self._parse_sof(body)
                self.frame = frame
            elif marker in UNSUPPORTED_SOF:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec,
                    f"unsupported JPEG coding process: "
                    f"{UNSUPPORTED_SOF[marker]}")
            elif marker == 0xDB:
                self._parse_dqt(body)
            elif marker == 0xC4:
                self._parse_dht(body)
            elif marker == 0xDD:
                if frame is None:
                    self._pending_dri = _u16(body, 0)
                else:
                    frame.restart_interval = _u16(body, 0)
            elif marker == 0xDA:
                if frame is None:
                    raise HeifError.invalid_input(
                        SubError.Invalid_parameter_value, "SOS before SOF")
                pos = self._decode_scan(body, pos)
            # APPn/COM and anything else: skipped
        if frame is None:
            raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                          "no SOF in JPEG stream")
        return frame

    # ----------------------------------------------------------- segments

    def _parse_sof(self, body: bytes) -> JpegFrame:
        if len(body) < 6:
            raise HeifError.eof("short SOF")
        precision = body[0]
        height = _u16(body, 1)
        width = _u16(body, 3)
        ncomp = body[5]
        if precision != 8:
            raise HeifError.unsupported(SubError.Unsupported_bit_depth,
                                        f"JPEG precision {precision}")
        if height == 0 or width == 0:
            raise HeifError.invalid_input(SubError.Invalid_image_size,
                                          "zero JPEG dimensions")
        frame = JpegFrame(precision, width, height)
        if hasattr(self, "_pending_dri"):
            frame.restart_interval = self._pending_dri
        if len(body) < 6 + 3 * ncomp:
            raise HeifError.eof("short SOF component list")
        for i in range(ncomp):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    f"bad sampling factors {h}x{v}")
            frame.components.append(JpegComponent(cid, h, v, tq))
        # carry tables parsed before SOF
        if self.frame is not None:
            frame.quant.update(self.frame.quant)
            frame.huff_dc.update(self.frame.huff_dc)
            frame.huff_ac.update(self.frame.huff_ac)
        if getattr(self, "_tables", None):
            q, dc, ac = self._tables
            frame.quant.update(q)
            frame.huff_dc.update(dc)
            frame.huff_ac.update(ac)
        return frame

    def _tables_dicts(self):
        if self.frame is not None:
            return (self.frame.quant, self.frame.huff_dc, self.frame.huff_ac)
        if not hasattr(self, "_tables") or self._tables is None:
            self._tables = ({}, {}, {})
        return self._tables

    def _parse_dqt(self, body: bytes):
        quant, _, _ = self._tables_dicts()
        pos = 0
        while pos < len(body):
            pq = body[pos] >> 4
            tq = body[pos] & 15
            pos += 1
            count = 64 * (2 if pq else 1)
            if pos + count > len(body):
                raise HeifError.eof("short DQT")
            if pq:
                vals = np.frombuffer(body, ">u2", 64, pos).astype(np.int32)
            else:
                vals = np.frombuffer(body, np.uint8, 64, pos).astype(np.int32)
            pos += count
            table = np.zeros(64, np.int32)
            table[ZIGZAG] = vals     # DQT is in zigzag order → natural
            quant[tq] = table

    def _parse_dht(self, body: bytes):
        _, huff_dc, huff_ac = self._tables_dicts()
        pos = 0
        while pos + 17 <= len(body):
            tc = body[pos] >> 4
            th = body[pos] & 15
            bits_b = body[pos + 1:pos + 17]
            nvals = sum(bits_b)
            pos += 17
            if pos + nvals > len(body):
                raise HeifError.eof("short DHT")
            vals_b = body[pos:pos + nvals]
            pos += nvals
            # tables repeat across images (Annex K defaults are near
            # universal): cache construction by content
            key = (bits_b, vals_b)
            table = _DHT_CACHE.get(key)
            if table is None:
                table = HuffTable(list(bits_b), list(vals_b))
                if len(_DHT_CACHE) < 64:
                    _DHT_CACHE[key] = table
            (huff_ac if tc else huff_dc)[th] = table

    # --------------------------------------------------------------- scan

    def _decode_scan(self, body: bytes, pos: int) -> int:
        """Decode one (baseline) scan; returns new stream position."""
        with span("jpeg.scan"):
            return self._decode_scan_body(body, pos)

    def _decode_scan_body(self, body: bytes, pos: int) -> int:
        frame = self.frame
        ns = body[0]
        comps: List[Tuple[JpegComponent, int, int]] = []
        for i in range(ns):
            cs, tdta = body[1 + 2 * i:3 + 2 * i]
            comp = next((c for c in frame.components if c.comp_id == cs),
                        None)
            if comp is None:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    f"scan references unknown component {cs}")
            comps.append((comp, tdta >> 4, tdta & 15))
        # Ss/Se/Ah/Al ignored for sequential

        # locate end of entropy data: next marker that is not
        # RSTn/stuffing — vectorized over the 0xFF positions (a
        # byte-wise Python walk here dominated whole-image decode)
        data = self.data
        n = len(data)
        arr = np.frombuffer(data, np.uint8)
        ffs = np.nonzero(arr[pos:n - 1] == 0xFF)[0]
        end = n - 1 if n > pos else pos
        for off in ffs:
            nxt = arr[pos + off + 1]
            if nxt != 0x00 and not (0xD0 <= nxt <= 0xD7):
                end = pos + int(off)
                break
        entropy = data[pos:end]

        # allocate coefficient arrays
        interleaved = ns > 1
        h_max, v_max = frame.h_max, frame.v_max
        mcus_w = -(-frame.width // (8 * h_max))
        mcus_h = -(-frame.height // (8 * v_max))
        for comp, _, _ in comps:
            if interleaved:
                comp.blocks_w = mcus_w * comp.h
                comp.blocks_h = mcus_h * comp.v
            else:
                cw = -(-frame.width * comp.h // h_max)
                chh = -(-frame.height * comp.v // v_max)
                comp.blocks_w = -(-cw // 8)
                comp.blocks_h = -(-chh // 8)
            comp.coeffs = np.zeros((comp.blocks_h * comp.blocks_w, 64),
                                   np.int16)

        if interleaved:
            total_mcus = mcus_w * mcus_h
        else:
            comp = comps[0][0]
            total_mcus = comp.blocks_w * comp.blocks_h

        if self._decode_scan_entropy_native(entropy, frame, comps,
                                            interleaved, mcus_w, total_mcus):
            return end

        # split on restart markers
        segments = self._split_restarts(entropy)
        ri = frame.restart_interval or total_mcus
        mcu = 0
        for seg in segments:
            reader = BitReader(unstuff(seg))
            preds = {c.comp_id: 0 for c, _, _ in comps}
            seg_end = min(mcu + ri, total_mcus)
            while mcu < seg_end:
                self._decode_mcu(reader, frame, comps, interleaved,
                                 mcus_w, mcu, preds)
                mcu += 1
            if reader.exhausted:
                # libjpeg behavior: warn + pad with zero bits rather
                # than failing the whole image (jdhuff "premature end")
                frame.warnings.append(
                    f"premature end of entropy-coded data at MCU {mcu}")
            if mcu >= total_mcus:
                break
        if mcu < total_mcus:
            # segments ran out (missing restart intervals): decode the
            # remaining MCUs from zero bits, as libjpeg's resync does
            frame.warnings.append(
                f"JPEG scan truncated: {mcu}/{total_mcus} MCUs")
            reader = BitReader(np.zeros(0, np.uint8))
            preds = {c.comp_id: 0 for c, _, _ in comps}
            while mcu < total_mcus:
                self._decode_mcu(reader, frame, comps, interleaved,
                                 mcus_w, mcu, preds)
                mcu += 1
        return end

    def _decode_scan_entropy_native(self, entropy, frame: JpegFrame,
                                    comps, interleaved: bool, mcus_w: int,
                                    total_mcus: int) -> bool:
        """Run the scan through the C++ scan (host/jpeg_scan.cc).  Returns
        False to use the Python scan instead: exotic table ids, or
        restart segments that ran out (the Python scan pads and warns)."""
        if not self.native:
            return False
        for _, td, ta in comps:
            if not (0 <= td <= 3 and 0 <= ta <= 3):
                return False
            if td not in frame.huff_dc or ta not in frame.huff_ac:
                return False
        rc, exhausted = native_scan.decode_scan(
            entropy, comps, frame.huff_dc, frame.huff_ac, interleaved,
            mcus_w, total_mcus, frame.restart_interval)
        if rc == native_scan.INVALID_CODE:
            raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                          "invalid huffman code")
        if rc == native_scan.AC_OUT_OF_RANGE:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value,
                "AC coefficient index out of range")
        if rc != native_scan.OK:
            return False
        if exhausted:
            frame.warnings.append(
                "premature end of entropy-coded data")
        return True

    @staticmethod
    def _split_restarts(entropy: bytes) -> List[bytes]:
        out = []
        start = 0
        i = 0
        n = len(entropy)
        while i < n - 1:
            if entropy[i] == 0xFF and 0xD0 <= entropy[i + 1] <= 0xD7:
                out.append(entropy[start:i])
                start = i + 2
                i += 2
            else:
                i += 1
        out.append(entropy[start:])
        return out

    def _decode_mcu(self, reader: BitReader, frame: JpegFrame, comps,
                    interleaved: bool, mcus_w: int, mcu: int, preds):
        if interleaved:
            my, mx = divmod(mcu, mcus_w)
            for comp, td, ta in comps:
                dc_t = frame.huff_dc.get(td)
                ac_t = frame.huff_ac.get(ta)
                if dc_t is None or ac_t is None:
                    raise HeifError.invalid_input(
                        SubError.Invalid_parameter_value,
                        "missing huffman table")
                for by in range(comp.v):
                    for bx in range(comp.h):
                        row = my * comp.v + by
                        col = mx * comp.h + bx
                        idx = row * comp.blocks_w + col
                        self._decode_block(reader, comp, idx, dc_t, ac_t,
                                           preds)
        else:
            comp, td, ta = comps[0]
            dc_t = frame.huff_dc.get(td)
            ac_t = frame.huff_ac.get(ta)
            if dc_t is None or ac_t is None:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value, "missing huffman table")
            self._decode_block(reader, comp, mcu, dc_t, ac_t, preds)

    @staticmethod
    def _decode_block(reader: BitReader, comp: JpegComponent, idx: int,
                      dc_t: HuffTable, ac_t: HuffTable, preds):
        block = comp.coeffs[idx]
        s = reader.decode_symbol(dc_t)
        diff = extend(reader.read_bits(s), s) if s else 0
        preds[comp.comp_id] += diff
        block[0] = preds[comp.comp_id]
        k = 1
        while k < 64:
            rs = reader.decode_symbol(ac_t)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r == 15:         # ZRL
                    k += 16
                    continue
                break               # EOB
            k += r
            if k > 63:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    "AC coefficient index out of range")
            block[k] = extend(reader.read_bits(s), s)
            k += 1


# ------------------------------------------------------------------ recon

class BatchMismatch(ValueError):
    """Frames that one batch cannot take together (different size,
    sampling factors or component count), or grid tiles whose planes
    would overlap; the grid path then decodes tile by tile."""


def parse_jpeg(data) -> JpegFrame:
    """Host parse of a complete stream: markers, tables and every scan's
    coefficients, checked for what the reconstruction needs."""
    with span("jpeg.parse"):
        frame = JpegParser(bytes(data)).parse()
    for c in frame.components:
        if c.coeffs is None:
            raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                          "component missing from scans")
        if c.tq not in frame.quant:
            raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                          f"missing quant table {c.tq}")
    return frame


def component_size(frame: JpegFrame, c: JpegComponent) -> Tuple[int, int]:
    """(width, height) of a component's cropped plane (JAX ``_crop``)."""
    return (-(-frame.width * c.h // frame.h_max),
            -(-frame.height * c.v // frame.v_max))


def image_format(frame: JpegFrame) -> Tuple[str, str]:
    """(colorspace, chroma) of the decoded image, or Unsupported for
    component counts and sampling geometries the JAX package refuses."""
    ncomp = len(frame.components)
    if ncomp == 1:
        return Colorspace.Monochrome, Chroma.Monochrome
    if ncomp == 3:
        h_max, v_max = frame.h_max, frame.v_max
        hv = [(c.h, c.v) for c in frame.components]
        rel = [(h_max // h if h_max % h == 0 else 0,
                v_max // v if v_max % v == 0 else 0) for h, v in hv]
        if rel[1] != rel[2] or rel[0] != (1, 1):
            raise HeifError.unsupported(
                SubError.Unsupported_color_conversion,
                f"unsupported JPEG sampling {hv}")
        sub = {(1, 1): Chroma.C444, (2, 1): Chroma.C422,
               (2, 2): Chroma.C420}.get(rel[1])
        if sub is None:
            raise HeifError.unsupported(
                SubError.Unsupported_color_conversion,
                f"unsupported JPEG chroma geometry {hv}")
        return Colorspace.YCbCr, sub
    raise HeifError.unsupported(SubError.Unsupported_color_conversion,
                                f"JPEG with {ncomp} components")


def channels(frame: JpegFrame) -> List[str]:
    if len(frame.components) == 1:
        return [Channel.Y]
    return [Channel.Y, Channel.Cb, Channel.Cr]


def batch_key(frame: JpegFrame) -> tuple:
    """What the frames of one grid batch share: size, sampling factors and
    component count (so one composed image takes them all)."""
    return (frame.width, frame.height,
            tuple((c.h, c.v) for c in frame.components),
            len(frame.components))


def reconstruct(frames: Sequence[JpegFrame],
                outs: Sequence[Sequence[Optional[torch.Tensor]]]) -> None:
    """Every component of every frame into its output view (``outs[i][k]``
    for component k of frame i: a uint8 (h, w) view no larger than the
    component's blocks, or None to skip it), in one launch of
    jpeg_dequant_idct on the views' device."""
    with span("jpeg.recon"):
        coeffs, quant, jobs = [], [], []
        first = 0
        for frame, views in zip(frames, outs):
            rows = {}
            for c, out in zip(frame.components, views):
                n = c.blocks_w * c.blocks_h
                if out is not None:
                    if c.tq not in rows:
                        rows[c.tq] = len(quant)
                        quant.append(frame.quant[c.tq])
                    jobs.append(Job(first, c.blocks_w, c.blocks_h,
                                    rows[c.tq], out))
                coeffs.append(c.coeffs)
                first += n
        if not jobs:
            return
        dev = jobs[0].out.device
        # gathered into pinned memory on the way to a card, so the copy
        # runs at the link's rate and does not wait for the stream
        with span("jpeg.recon.gather"):
            host = torch.empty((first, 64), dtype=torch.int16,
                               pin_memory=dev.type == "cuda")
            np.concatenate(coeffs, out=host.numpy())
        with span("jpeg.recon.copy"):
            quant_d = torch.from_numpy(np.stack(quant).astype(np.int32)) \
                .to(dev)
            coeffs_d = host.to(dev, non_blocking=True)
        with span("jpeg.recon.launch"):
            dequant_idct(coeffs_d, quant_d, jobs)


def frame_image(frame: JpegFrame, limits=None) -> PixelImage:
    """The frame's PixelImage without planes: size, format, its warnings
    and the BT.601 full-range nclx of JFIF."""
    colorspace, chroma = image_format(frame)
    img = PixelImage(frame.width, frame.height, colorspace, chroma, limits)
    for wmsg in frame.warnings:
        img.add_warning(HeifError.eof(wmsg))
    if colorspace == Colorspace.YCbCr:
        img.color_profile_nclx = NclxProfile(
            color_primaries=2, transfer_characteristics=2,
            matrix_coefficients=6, full_range_flag=True)
    return img


def decode_jpeg(data, device=None, limits=None) -> PixelImage:
    """Decode a complete JFIF/raw JPEG stream to a PixelImage on
    ``device`` (None means CUDA)."""
    return decode_frame(parse_jpeg(data), device, limits)


def decode_frame(frame: JpegFrame, device=None, limits=None) -> PixelImage:
    """A parsed frame's image, reconstructed on ``device`` in one launch."""
    img = frame_image(frame, limits)
    dev = resolve_device(device)
    planes = []
    for c in frame.components:
        cw, ch = component_size(frame, c)
        planes.append(torch.empty((ch, cw), dtype=torch.uint8, device=dev))
    reconstruct([frame], [planes])
    for name, p in zip(channels(frame), planes):
        img.set_plane(name, p, 8)
    return img


def compose(frames: Sequence[JpegFrame], columns: int, width: int,
            height: int, device, limits=None) -> PixelImage:
    """Decode a grid's frames (tile i at column i mod ``columns``) into
    one (width, height) image on ``device``, one launch for all of them:
    each tile's planes are written at its place in the composed planes,
    clipped to them, as ``PixelImage.copy_into`` pastes.  Raises
    BatchMismatch for frames of different batch keys, or a chroma tile
    size that would make neighbouring tiles overlap."""
    key = batch_key(frames[0])
    if any(batch_key(f) != key for f in frames):
        raise BatchMismatch("the grid's JPEG tiles differ in size, "
                            "sampling or component count")
    colorspace, chroma = image_format(frames[0])
    sh, sv = chroma_subsampling(chroma)
    tw, th = frames[0].width, frames[0].height
    if tw % sh or th % sv:
        raise BatchMismatch(f"{tw}x{th} tiles overlap in {chroma} chroma")
    out = PixelImage(width, height, colorspace, chroma, limits)
    names = channels(frames[0])
    views = []
    with span("grid.compose"):
        for name in names:
            out.add_plane(name, bit_depth=8, device=device)
        for idx, frame in enumerate(frames):
            ty, tx = divmod(idx, columns)
            row = []
            for name, c in zip(names, frame.components):
                dst = out.plane(name)
                d = (sh, sv) if name in (Channel.Cb, Channel.Cr) \
                    else (1, 1)
                x, y = tx * tw // d[0], ty * th // d[1]
                cw, ch = component_size(frame, c)
                w = min(cw, dst.shape[1] - x)
                h = min(ch, dst.shape[0] - y)
                row.append(dst[y:y + h, x:x + w] if w > 0 and h > 0
                           else None)
            views.append(row)
    reconstruct(frames, views)
    return out


class JpegDecoder:
    """jpeg item decoder (ref: decoder_libjpeg.cc, JAX JpegDecoder)."""

    def __init__(self, device=None):
        self.device = device

    def decode_single_image(self, config_box, data, declared_size=None,
                            limits=None) -> PixelImage:
        return decode_frame(parse_item(config_box, data, declared_size,
                                       limits), self.device, limits)


def parse_item(config_box, data, declared_size=None,
               limits=None) -> JpegFrame:
    """Host parse of a jpeg item's stream, checked against the security
    limits before (the declared size) and after (the coded size).  A
    ``jpgC``'s bytes go in front of the item data, as libheif's decoder
    does with the configuration data (the JAX package ignores the box)."""
    if limits is not None and declared_size:
        limits.check_image_size(*declared_size)
    if config_box is not None and config_box.data:
        data = bytes(config_box.data) + bytes(data)
    frame = parse_jpeg(data)
    if limits is not None:
        limits.check_image_size(frame.width, frame.height)
    return frame
