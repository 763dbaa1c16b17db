"""HEVC still-image decoder: from hvcC and NALs to a PixelImage on the
device.

Counterpart of libheif_tpu/codecs/hevc/decoder.py (:24-105, :334-370 and
the device engine of decode_intra_picture and HevcDecoder), reference:
libheif/plugins/decoder_libde265.cc:479-521.  The C++ parser runs on the
host; the reconstruction runs on the context's device (device_recon).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...core.error import HeifError, SubError
from ...core.trace import span
from ...boxes.codec_cfg import (emulation_prevention_positions,
                                remove_emulation_prevention)
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from . import headers as H
from .ctu import SliceSyntax
from .device_recon import decode_pictures_device
from .native_parse import parse_slice_raw


def split_length_prefixed(data: bytes, length_size: int) -> List[bytes]:
    """hvcC-style length-prefixed NAL stream → NAL list
    (ref: nalu_utils.cc length-prefix handling)."""
    out = []
    pos = 0
    n = len(data)
    while pos + length_size <= n:
        ln = int.from_bytes(data[pos:pos + length_size], "big")
        pos += length_size
        if ln == 0 or pos + ln > n:
            break
        out.append(data[pos:pos + ln])
        pos += ln
    return out


def _substreams(nal: bytes, rbsp: bytes, data_offset_bits: int,
                entry_offsets: List[int]) -> List[Tuple[int, int]]:
    """WPP substream (byte_start, byte_end) ranges within the RBSP.

    entry_point offsets count bytes in the raw NAL (incl. emulation
    prevention, spec §7.4.7.1); convert to RBSP positions by
    subtracting the EPBs inside each range (vectorized cumulative map).
    """
    data_start = data_offset_bits // 8
    if not entry_offsets:
        return [(data_start, len(rbsp))]
    payload = nal[2:]
    epb = np.asarray(emulation_prevention_positions(payload), np.int64)
    n = len(payload)
    # raw→rbsp: count of non-EPB bytes strictly before each raw index
    is_epb = np.zeros(n + 1, np.int64)
    if len(epb):
        is_epb[epb] = 1
    raw_to_rbsp = np.concatenate(([0], np.cumsum(1 - is_epb[:-1])))
    # rbsp→raw for the data start: index of the (data_start+1)-th
    # non-EPB byte
    keep = np.nonzero(is_epb[:n] == 0)[0]
    raw_data_start = int(keep[data_start])

    bounds_raw = [raw_data_start]
    acc = raw_data_start
    for off in entry_offsets:
        acc += off
        if acc > n:   # corrupt/truncated: offsets past the payload
            raise HeifError.invalid_input(
                msg="WPP entry point offset beyond slice data")
        bounds_raw.append(acc)
    bounds_raw.append(n)
    subs = []
    for k in range(len(bounds_raw) - 1):
        s = int(raw_to_rbsp[bounds_raw[k]])
        e = int(raw_to_rbsp[bounds_raw[k + 1]])
        subs.append((s, e))
    return subs


def check_picture_supported(sps: H.SPS, pps: H.PPS,
                            slice_nals: List[bytes]) -> None:
    """Raise Unsupported, naming the feature, for what the port does not
    decode: HEVC tiles, chroma other than 4:2:0, bit depths other than
    8/10/12 (equal for luma and chroma), and cu_qp_delta in pictures of
    several slice NALs (``check_slices`` reads the slice headers)."""
    if pps.tiles_enabled:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "HEVC tiles not yet supported")
    if sps.chroma_format_idc != 1:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "only 4:2:0 supported currently")
    if sps.bit_depth_luma not in (8, 10, 12) or \
            sps.bit_depth_chroma != sps.bit_depth_luma:
        raise HeifError.unsupported(
            SubError.Unsupported_bit_depth,
            "bit depth %d/%d not supported (8/10/12-bit equal-depth only)"
            % (sps.bit_depth_luma, sps.bit_depth_chroma))
    if not slice_nals:
        raise HeifError.invalid_input(msg="no slice NAL in the picture")
    if len(slice_nals) > 1 and pps.cu_qp_delta_enabled:
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            "cu_qp_delta across several slices not yet supported")


def check_slices(sps: H.SPS, pps: H.PPS,
                 headers: List[H.SliceHeader]) -> None:
    """The slice headers of a picture of several slices: dependent slice
    segments, and under WPP a slice segment that starts inside a CTB row,
    raise Unsupported."""
    if len(headers) < 2:
        return
    if any(h.dependent_slice for h in headers):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "dependent slice segments")
    if pps.entropy_coding_sync_enabled and any(
            h.segment_address % sps.pic_width_in_ctbs for h in headers[1:]):
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            "WPP with a slice segment starting inside a CTB row not yet "
            "supported")


def parse_picture(sps: H.SPS, pps: H.PPS, slice_nals: List[bytes]):
    """Host entropy decode of one intra picture (span hevc.parse) →
    (SliceSyntax, (cols, coeff_buf, offs)), the input of device_recon."""
    with span("hevc.parse"):
        return _parse_picture(sps, pps, slice_nals)


def _parse_picture(sps: H.SPS, pps: H.PPS, slice_nals: List[bytes]):
    """The picture's slice segments, one after the other: each parses
    its CTBs into the picture's shared maps (the JAX package's
    ``_parse_multi_slice`` rules: addresses contiguous from 0, every CTB
    covered, else invalid_input)."""
    check_picture_supported(sps, pps, slice_nals)
    headers = [H.parse_slice_header(nal, sps, {pps.pps_id: pps})
               for nal in slice_nals]
    check_slices(sps, pps, headers)
    syn = SliceSyntax(sps, pps, headers[0])
    syn.slice_headers = headers
    n_ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
    cols_l, coeff_l, offs_l = [], [], []
    pos = 0
    next_ctb = 0
    for idx, (nal, sh) in enumerate(zip(slice_nals, headers)):
        start = 0 if sh.first_slice_in_pic else sh.segment_address
        if start != next_ctb:
            raise HeifError.invalid_input(
                msg=f"slice segment address {start}, expected {next_ctb}")
        rbsp = remove_emulation_prevention(nal[2:])
        subs = _substreams(nal, rbsp, sh.data_offset_bits,
                           sh.entry_point_offsets)
        cols, coeff, offs, last = parse_slice_raw(
            sps, pps, sh, rbsp, subs, syn, idx, start,
            one_slice=len(slice_nals) == 1)
        cols_l.append(cols)
        coeff_l.append(coeff)
        offs_l.append(np.where(offs >= 0, offs + pos, -1))
        pos += len(coeff)
        next_ctb = last + 1
        if next_ctb >= n_ctbs and idx + 1 < len(slice_nals):
            raise HeifError.invalid_input(
                msg=f"slice {idx + 1} after the picture's last CTB")
    if next_ctb != n_ctbs:
        raise HeifError.invalid_input(
            msg=f"slices cover {next_ctb}/{n_ctbs} CTBs")
    if len(cols_l) == 1:
        return syn, (cols_l[0], coeff_l[0], offs_l[0])
    return syn, (np.concatenate(cols_l), np.concatenate(coeff_l),
                 np.concatenate(offs_l))


def decode_intra_picture(sps: H.SPS, pps: H.PPS, slice_nals: List[bytes],
                         device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one intra picture from its slice NALs → the uncropped
    (Y, Cb, Cr) int32 planes on ``device`` (None means CUDA)."""
    syn, raw = parse_picture(sps, pps, slice_nals)
    return decode_pictures_device([syn], [raw], device)[0]


def extract_stream(config_box, data: bytes):
    """hvcC + item payload → (sps, pps, slice NAL list)."""
    if config_box is None:
        raise HeifError.invalid_input(SubError.No_hvcC_box)
    sps = pps = None
    for nal in config_box.get_header_nals():
        t = H.nal_type(nal)
        if t == H.NAL_SPS:
            sps = H.parse_sps(nal)
        elif t == H.NAL_PPS:
            pps = H.parse_pps(nal)
    slices = []
    for nal in split_length_prefixed(data, config_box.length_size):
        t = H.nal_type(nal)
        if t == H.NAL_SPS:
            sps = H.parse_sps(nal)
        elif t == H.NAL_PPS:
            pps = H.parse_pps(nal)
        elif H.is_slice(t):
            slices.append(nal)
    if sps is None or pps is None:
        raise HeifError.invalid_input(SubError.No_hvcC_box,
                                      "missing SPS/PPS")
    return sps, pps, slices


def crop_to_conformance(sps: H.SPS, y, cb, cr):
    """Apply the SPS conformance window to uncropped planes."""
    w, h = sps.cropped_size
    sub_w = 2 if sps.chroma_format_idc in (1, 2) else 1
    sub_h = 2 if sps.chroma_format_idc == 1 else 1
    l, _, t, _ = sps.conf_win
    y = y[t * sub_h:t * sub_h + h, l * sub_w:l * sub_w + w]
    cb = cb[t:t + (h + 1) // 2, l:l + (w + 1) // 2]
    cr = cr[t:t + (h + 1) // 2, l:l + (w + 1) // 2]
    return y, cb, cr


def check_size(sps: H.SPS, declared_size, limits) -> None:
    """The coded size against the security limits and, where known, the
    declared (ispe) size (ref: decoder.h:108-125 security check)."""
    if limits is None:
        return
    limits.check_image_size(sps.pic_width, sps.pic_height)
    if declared_size is not None:
        dw, dh = declared_size
        if sps.pic_width * sps.pic_height > \
                max(4 * dw * dh, dw * dh + (1 << 16)):
            raise HeifError.security(
                "coded size much larger than declared size")


def planes_to_image(sps: H.SPS, y, cb, cr, limits=None) -> PixelImage:
    """Uncropped int32 planes → the cropped 4:2:0 PixelImage (uint8, or
    uint16 above 8 bits) on the planes' device."""
    y, cb, cr = crop_to_conformance(sps, y, cb, cr)
    w, h = sps.cropped_size
    img = PixelImage(w, h, Colorspace.YCbCr, Chroma.C420, limits)
    for ch, p, bd in ((Channel.Y, y, sps.bit_depth_luma),
                      (Channel.Cb, cb, sps.bit_depth_chroma),
                      (Channel.Cr, cr, sps.bit_depth_chroma)):
        dt = torch.uint8 if bd <= 8 else torch.int16
        plane = p.to(dt).contiguous()
        img.set_plane(ch, plane if bd <= 8 else plane.view(torch.uint16), bd)
    return img


class HevcDecoder:
    """hvc1 item decoder (ref: decoder_libde265.cc:479-521)."""

    def __init__(self, device=None):
        self.device = device

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        sps, pps, slices = extract_stream(config_box, data)
        check_size(sps, declared_size, limits)
        y, cb, cr = decode_intra_picture(sps, pps, slices, self.device)
        return planes_to_image(sps, y, cb, cr, limits)
