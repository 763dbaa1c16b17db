"""HEVC decoder: from hvcC and NALs to PixelImages on the device, for
stills and for sequences.

Counterpart of libheif_tpu/codecs/hevc/decoder.py (:24-105, :334-370 and
the device engine of decode_intra_picture and HevcDecoder; the sequence
side :195-465), reference: libheif/plugins/decoder_libde265.cc:479-521.
An intra picture parses in the C++ parser on the host; a P or B picture
in the Python slice parser (ctu.SliceParser, spans hevc.parse and
hevc.parse.inter).  Either reconstructs on the context's device
(device_recon), a P or B picture from the reference pictures of a DPB
that lives on the device too (``DeviceDpb``); the motion of each
picture, which TMVP reads, stays on the host.

Refused by name (Unsupported): weighted prediction and long-term
reference pictures (headers.parse_slice_header), a P or B picture of
several slice segments, and constrained_intra_pred_flag in a picture
with inter slices (the JAX package ignores the flag; its intra
prediction would read inter samples the flag forbids).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..._build import resolve_device
from ...core.error import HeifError, SubError
from ...core.trace import span
from ...boxes.codec_cfg import (emulation_prevention_positions,
                                remove_emulation_prevention)
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from . import headers as H
from .ctu import ColMotion, SliceParser, SliceSyntax, raw_tus
from .device_recon import build_plan, decode_pictures_device, reconstruct
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


DPB_SIZE = 8            # pictures the DPB keeps, the JAX package's bound


class DeviceDpb:
    """The decoded picture buffer on the device: the deblocked, SAO'd
    planes of up to DPB_SIZE pictures (and the one being stored) in the
    slots of two int32 tensors, (slots, H, W) luma and (slots, 2, H/2,
    W/2) chroma, which hevc_inter_pred reads; ``slot`` maps a POC to its
    slot."""

    def __init__(self, sps: H.SPS, device):
        W, Hh = sps.pic_width, sps.pic_height
        n = DPB_SIZE + 1
        self.y = torch.zeros((n, Hh, W), dtype=torch.int32, device=device)
        self.c = torch.zeros((n, 2, Hh >> 1, W >> 1), dtype=torch.int32,
                             device=device)
        self.slot: Dict[int, int] = {}

    def __contains__(self, poc: int) -> bool:
        return poc in self.slot

    def clear(self) -> None:
        self.slot.clear()

    def store(self, poc: int, y, cb, cr) -> None:
        """Copy a picture's planes into a free slot (its old one if the
        POC is there already)."""
        used = set(self.slot.values())
        k = self.slot.get(poc)
        if k is None:
            k = next(i for i in range(self.y.shape[0]) if i not in used)
        self.y[k].copy_(y)
        self.c[k, 0].copy_(cb)
        self.c[k, 1].copy_(cr)
        self.slot[poc] = k

    def evict(self) -> None:
        """Keep the DPB_SIZE most recent pictures by POC."""
        while len(self.slot) > DPB_SIZE:
            del self.slot[min(self.slot)]


def _first_slice_in_pic(nal: bytes) -> bool:
    """first_slice_segment_in_pic_flag: the slice header's first bit."""
    return len(nal) > 2 and bool(nal[2] & 0x80)


class SequenceDecoder:
    """Stateful HEVC sequence decoder (I, P and B pictures): POC
    derivation (spec 8.3.1), reference lists from the short-term RPS with
    list modification (spec 8.3.2/8.3.4), the collocated picture for
    TMVP, and a DPB bounded at DPB_SIZE pictures by POC.  Counterpart of
    JAX decoder.py SequenceDecoder :195-331, one picture (all its slice
    NALs) at a time: an all-intra picture through the C++ parser (several
    slices too), a P or B picture (one slice segment) through the Python
    parser; both reconstruct on ``device``, and the DPB holds the
    filtered planes there (``DeviceDpb``)."""

    def __init__(self, sps: H.SPS, pps: H.PPS, device=None):
        self.sps = sps
        self.pps = pps
        self.device = resolve_device(device)
        self.dpb = DeviceDpb(sps, self.device)
        self.motion: Dict[int, Optional[ColMotion]] = {}  # TMVP, host side
        self.prev_poc = 0

    def _poc(self, sh: H.SliceHeader, nal_t: int) -> int:
        if nal_t in (19, 20):       # IDR
            return 0
        max_lsb = 1 << self.sps.log2_max_pic_order_cnt_lsb
        prev_lsb = self.prev_poc & (max_lsb - 1)
        prev_msb = self.prev_poc - prev_lsb
        lsb = sh.poc_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        return msb + lsb

    @staticmethod
    def _rps_pocs(rps, poc):
        """(st_curr_before, st_curr_after) absolute POCs."""
        before, after = [], []
        acc = 0
        for d, used in zip(rps.delta_poc_s0, rps.used_s0):
            acc -= d
            if used:
                before.append(poc + acc)
        acc = 0
        for d, used in zip(rps.delta_poc_s1, rps.used_s1):
            acc += d
            if used:
                after.append(poc + acc)
        return before, after

    def _ref_list(self, init_list, n, rplm):
        """The POCs of one reference list (RefPicListTemp, spec 8.3.4),
        each checked to be in the DPB."""
        if not init_list:
            raise HeifError.invalid_input(
                msg="inter slice with an empty reference list")
        if rplm is not None:
            pocs = [init_list[i] for i in rplm]
        else:
            pocs = [init_list[i % len(init_list)] for i in range(n)]
        for p in pocs:
            if p not in self.dpb:
                raise HeifError.invalid_input(
                    msg=f"reference picture POC {p} not in DPB")
        return pocs

    def decode_picture(self, nals: List[bytes]):
        """Decode one picture from its slice NALs; returns (poc, (y, cb,
        cr)), the uncropped int32 planes on the device."""
        t = H.nal_type(nals[0])
        pmap = {self.pps.pps_id: self.pps}
        headers = [H.parse_slice_header(nal, self.sps, pmap) for nal in nals]
        sh = headers[0]
        poc = self._poc(sh, t)
        if t in (19, 20):           # IDR: fresh DPB
            self.dpb.clear()
            self.motion.clear()
        if all(h.slice_type == 2 for h in headers):
            syn, raw = parse_picture(self.sps, self.pps, nals)
            planes = decode_pictures_device([syn], [raw], self.device)[0]
            motion = None             # all intra: no temporal candidates
        else:
            planes, motion = self._decode_inter(nals[0], headers, poc)
        self._store(poc, planes, t)
        self.motion[poc] = motion
        self.motion = {p: m for p, m in self.motion.items()
                       if p in self.dpb}
        return poc, planes

    def _decode_inter(self, nal: bytes, headers, poc: int):
        if len(headers) > 1:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "P/B pictures of several slice segments not yet supported")
        if self.pps.constrained_intra_pred:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "constrained_intra_pred_flag in P/B pictures not supported")
        check_picture_supported(self.sps, self.pps, [nal])
        sh = headers[0]
        if sh.rps is None:
            raise HeifError.invalid_input(
                msg="inter slice without a reference picture set")
        before, after = self._rps_pocs(sh.rps, poc)
        # RefPicListTemp0 = StCurrBefore + StCurrAfter (spec 8.3.4)
        pocs0 = self._ref_list(before + after, sh.num_ref_idx_l0,
                               sh.rplm_l0)
        pocs1 = []
        if sh.slice_type == 0:       # B: RefPicListTemp1 = After + Before
            pocs1 = self._ref_list(after + before, sh.num_ref_idx_l1,
                                   sh.rplm_l1)
        col_motion = None
        if sh.temporal_mvp:
            # collocated picture (spec 8.5.3.2.8): list per
            # collocated_from_l0, index collocated_ref_idx
            col_list = pocs0 if sh.collocated_from_l0 else pocs1
            if sh.collocated_ref_idx < len(col_list):
                col_motion = self.motion.get(col_list[sh.collocated_ref_idx])
        with span("hevc.parse"), span("hevc.parse.inter"):
            rbsp = remove_emulation_prevention(nal[2:])
            subs = _substreams(nal, rbsp, sh.data_offset_bits,
                               sh.entry_point_offsets)
            syn = SliceParser(self.sps, self.pps, sh, rbsp, subs,
                              ref_pocs_l0=pocs0, cur_poc=poc,
                              ref_pocs_l1=pocs1,
                              col_motion=col_motion).parse()
            syn.sao_from_params()
            raw = raw_tus(syn.tus)
        plan = build_plan([syn], [raw], self.device, ref_slots=(
            [self.dpb.slot[p] for p in pocs0],
            [self.dpb.slot[p] for p in pocs1]))
        y, cb, cr = reconstruct(plan, (self.dpb.y, self.dpb.c))
        return (y[0], cb[0], cr[0]), ColMotion.from_syntax(syn, poc)

    def _store(self, poc, planes, nal_t: int) -> None:
        self.dpb.store(poc, *planes)
        # prevTid0Pic (spec 8.3.1): sub-layer non-reference pictures
        # (even NAL types <= 14: TRAIL_N, TSA_N, …) do not anchor the
        # POC MSB derivation
        if not (nal_t <= 14 and nal_t % 2 == 0):
            self.prev_poc = poc
        self.dpb.evict()


class HevcSequenceSession:
    """One video track's decode session: pictures in decode order in,
    frames in output order out, reordered by POC up to the SPS's
    max_num_reorder_pics, drained before an IDR and by ``flush`` (JAX
    decoder.py :373-441; the reference's per-chunk decoder with the
    plugin's DPB, decoder.h:132-149).  A sample's slice NALs are grouped
    into pictures by first_slice_segment_in_pic_flag; each picture
    decodes whole."""

    def __init__(self, config_box, limits=None, device=None):
        sps = pps = None
        for nal in config_box.get_header_nals():
            t = H.nal_type(nal)
            if t == H.NAL_SPS:
                sps = H.parse_sps(nal)
            elif t == H.NAL_PPS:
                pps = H.parse_pps(nal)
        if sps is None or pps is None:
            raise HeifError.invalid_input(msg="hvcC without SPS/PPS")
        self.sps, self.pps = sps, pps
        self.limits = limits
        if limits is not None:
            limits.check_image_size(sps.pic_width, sps.pic_height)
        self.seq = SequenceDecoder(sps, pps, device)
        self.length_size = getattr(config_box, "length_size", 4)
        self.pending: List[PixelImage] = []
        self.max_reorder = sps.max_num_reorder_pics
        self.reorder: List[Tuple[int, PixelImage]] = []

    def push_sample(self, data: bytes) -> None:
        pics: List[List[bytes]] = []
        for nal in split_length_prefixed(data, self.length_size):
            t = H.nal_type(nal)
            if not H.is_slice(t):     # parameter sets, SEI
                continue
            if not pics or _first_slice_in_pic(nal):
                pics.append([])
            pics[-1].append(nal)
        for nals in pics:
            if H.nal_type(nals[0]) in (19, 20) and self.reorder:
                # a new IDR resets the POC: drain the previous GOP first
                self.flush()
            poc, planes = self.seq.decode_picture(nals)
            self.reorder.append((poc, planes_to_image(self.sps, *planes,
                                                      self.limits)))
            while len(self.reorder) > self.max_reorder:
                self._bump()

    def _bump(self) -> None:
        i = min(range(len(self.reorder)), key=lambda k: self.reorder[k][0])
        self.pending.append(self.reorder.pop(i)[1])

    def flush(self) -> None:
        """Drain the reorder buffer (end of stream, or before an IDR)."""
        while self.reorder:
            self._bump()

    def pull(self) -> Optional[PixelImage]:
        return self.pending.pop(0) if self.pending else None


class HevcDecoder:
    """hvc1 item and track decoder (ref: decoder_libde265.cc:479-521;
    the sequence push/flush/pull API, decoder.h:132-149)."""

    def __init__(self, device=None):
        self.device = device
        self._session: Optional[HevcSequenceSession] = None

    def start_sequence(self, config_box, limits=None) -> HevcSequenceSession:
        """A stateful session for a video track, on the decoder's device
        (also kept as the session of push/pull)."""
        self._session = HevcSequenceSession(config_box, limits, self.device)
        return self._session

    def push_sequence_data(self, data: bytes) -> None:
        if self._session is None:
            raise HeifError.usage(msg="push before start_sequence")
        self._session.push_sample(data)

    def pull_next_frame(self) -> Optional[PixelImage]:
        return None if self._session is None else self._session.pull()

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        sps, pps, slices = extract_stream(config_box, data)
        check_size(sps, declared_size, limits)
        y, cb, cr = decode_intra_picture(sps, pps, slices, self.device)
        return planes_to_image(sps, y, cb, cr, limits)
