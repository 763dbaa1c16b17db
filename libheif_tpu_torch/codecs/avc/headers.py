"""H.264/AVC NAL units and parameter-set parsing (Rec. ITU-T H.264 §7).

A copy of libheif_tpu/codecs/avc/headers.py, unchanged but for this line.

Host-side container work: annex-B / length-prefixed NAL handling, RBSP
unescape, SPS/PPS/slice-header parse. Replaces the header plumbing the
reference delegates to openh264 (reference: libheif/plugins/
decoder_openh264.cc) and the avcC assembly in libheif/codecs/
avc_boxes.cc.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ...core.bitstream import BitReader
from ...core.error import HeifError, SubError

NAL_SLICE_NON_IDR = 1
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9


def split_annexb(data: bytes) -> List[bytes]:
    """Split an annex-B byte stream into NAL units (no start codes).

    Scans with bytes.find (C speed) instead of a per-byte Python loop;
    a 3-byte code is 00 00 01, a 4-byte code contributes one extra
    leading zero which is stripped from the preceding payload."""
    nals = []
    n = len(data)
    pos = data.find(b"\x00\x00\x01")
    while pos >= 0:
        start = pos + 3
        nxt = data.find(b"\x00\x00\x01", start)
        if nxt < 0:
            nals.append(data[start:n])
            break
        end = nxt
        if end > start and data[end - 1] == 0:
            end -= 1   # 4-byte start code: 00 00 00 01
        nals.append(data[start:end])
        pos = nxt
    return [x for x in nals if x]


def split_length_prefixed(data: bytes, length_size: int) -> List[bytes]:
    """Split avcC-style length-prefixed NALs (ISO 14496-15)."""
    nals = []
    i = 0
    while i + length_size <= len(data):
        ln = int.from_bytes(data[i:i + length_size], "big")
        i += length_size
        if ln == 0 or i + ln > len(data):
            break
        nals.append(data[i:i + ln])
        i += ln
    return nals


def unescape_rbsp(nal: bytes) -> bytes:
    """Remove emulation-prevention bytes (spec 7.4.1.1), find-based.  A
    memoryview (an item's payload read in place) is taken as its bytes:
    ``in`` on a memoryview compares single bytes and finds no sequence."""
    nal = bytes(nal)
    if b"\x00\x00\x03" not in nal:
        return nal
    out = bytearray()
    i, n = 0, len(nal)
    while True:
        j = nal.find(b"\x00\x00\x03", i)
        if j < 0:
            out += nal[i:]
            break
        out += nal[i:j + 2]
        i = j + 3
    return bytes(out)


def nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F


# --------------------------------------------------------------------------
# SPS / PPS
# --------------------------------------------------------------------------

@dataclass
class SPS:
    profile_idc: int = 0
    level_idc: int = 0
    constraint_flags: int = 0
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: bool = False
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass: bool = False
    seq_scaling_matrix_present: bool = False
    scaling_list_4x4: Optional[List[np.ndarray]] = None
    scaling_list_8x8: Optional[List[np.ndarray]] = None
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_poc_lsb: int = 4
    max_num_ref_frames: int = 0
    gaps_in_frame_num_allowed: bool = False
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only: bool = True
    mb_adaptive_frame_field: bool = False
    direct_8x8_inference: bool = True
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    vui_present: bool = False

    @property
    def width(self) -> int:
        sub_w = 1 if self.chroma_format_idc == 0 else \
            (2 if self.chroma_format_idc in (1, 2) else 1)
        crop_unit_x = 1 if self.chroma_format_idc in (0, 3) else sub_w
        return self.pic_width_in_mbs * 16 - crop_unit_x * \
            (self.crop_left + self.crop_right)

    @property
    def height(self) -> int:
        sub_h = 2 if self.chroma_format_idc == 1 else 1
        crop_unit_y = (1 if self.chroma_format_idc in (0, 3) else sub_h) * \
            (1 if self.frame_mbs_only else 2)
        frame_h = (2 - int(self.frame_mbs_only)) * \
            self.pic_height_in_map_units * 16
        return frame_h - crop_unit_y * (self.crop_top + self.crop_bottom)


def _scaling_list(br: BitReader, size: int, fallback: np.ndarray,
                  default: np.ndarray) -> np.ndarray:
    """Parse one scaling list (spec 7.3.2.1.1.1); returns the list in
    raster order already un-zigzagged by the caller."""
    present = br.read_flag()
    if not present:
        return fallback
    last, nxt = 8, 8
    out = np.zeros(size, np.int32)
    for j in range(size):
        if nxt != 0:
            delta = br.read_se()
            nxt = (last + delta + 256) % 256
            if j == 0 and nxt == 0:
                return default
        out[j] = last = (nxt if nxt != 0 else last)
    return out


_DEFAULT_4X4_INTRA = np.array(
    [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
    np.int32)
_DEFAULT_4X4_INTER = np.array(
    [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34],
    np.int32)
_DEFAULT_8X8_INTRA = np.array(
    [6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
     23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
     27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
     31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42],
    np.int32)
_DEFAULT_8X8_INTER = np.array(
    [9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
     21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
     24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
     27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35],
    np.int32)

_FLAT16 = np.full(16, 16, np.int32)
_FLAT64 = np.full(64, 16, np.int32)


def _parse_scaling_matrices(br: BitReader, sps: "SPS",
                            n_8x8: int) -> None:
    l4: List[np.ndarray] = []
    for i in range(6):
        fb = (_DEFAULT_4X4_INTRA if i == 0 else l4[i - 1]) if i != 3 else \
            _DEFAULT_4X4_INTER
        if i in (1, 2):
            fb = l4[i - 1]
        elif i in (4, 5):
            fb = l4[i - 1]
        default = _DEFAULT_4X4_INTRA if i < 3 else _DEFAULT_4X4_INTER
        if i == 0:
            fb = _DEFAULT_4X4_INTRA
        elif i == 3:
            fb = _DEFAULT_4X4_INTER
        l4.append(_scaling_list(br, 16, fb, default))
    l8: List[np.ndarray] = []
    for i in range(n_8x8):
        if i == 0:
            fb, default = _DEFAULT_8X8_INTRA, _DEFAULT_8X8_INTRA
        elif i == 1:
            fb, default = _DEFAULT_8X8_INTER, _DEFAULT_8X8_INTER
        else:
            fb = l8[i - 2]
            default = _DEFAULT_8X8_INTRA if i % 2 == 0 else _DEFAULT_8X8_INTER
        l8.append(_scaling_list(br, 64, fb, default))
    sps.scaling_list_4x4 = l4
    sps.scaling_list_8x8 = l8


def parse_sps(nal: bytes) -> SPS:
    """(spec 7.3.2.1.1)."""
    rbsp = unescape_rbsp(nal[1:])
    br = BitReader(rbsp)
    s = SPS()
    s.profile_idc = br.read_bits(8)
    s.constraint_flags = br.read_bits(8)
    s.level_idc = br.read_bits(8)
    s.seq_parameter_set_id = br.read_ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128,
                         138, 139, 134, 135):
        s.chroma_format_idc = br.read_ue()
        if s.chroma_format_idc == 3:
            s.separate_colour_plane = br.read_flag()
        s.bit_depth_luma = br.read_ue() + 8
        s.bit_depth_chroma = br.read_ue() + 8
        s.qpprime_y_zero_transform_bypass = br.read_flag()
        s.seq_scaling_matrix_present = br.read_flag()
        if s.seq_scaling_matrix_present:
            _parse_scaling_matrices(
                br, s, 12 if s.chroma_format_idc == 3 else 2)
    s.log2_max_frame_num = br.read_ue() + 4
    s.pic_order_cnt_type = br.read_ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_poc_lsb = br.read_ue() + 4
    elif s.pic_order_cnt_type == 1:
        br.read_flag()
        br.read_se()
        br.read_se()
        for _ in range(br.read_ue()):
            br.read_se()
    s.max_num_ref_frames = br.read_ue()
    s.gaps_in_frame_num_allowed = br.read_flag()
    s.pic_width_in_mbs = br.read_ue() + 1
    s.pic_height_in_map_units = br.read_ue() + 1
    s.frame_mbs_only = br.read_flag()
    if not s.frame_mbs_only:
        s.mb_adaptive_frame_field = br.read_flag()
    s.direct_8x8_inference = br.read_flag()
    if br.read_flag():  # frame_cropping
        s.crop_left = br.read_ue()
        s.crop_right = br.read_ue()
        s.crop_top = br.read_ue()
        s.crop_bottom = br.read_ue()
    s.vui_present = br.read_flag()
    return s


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode: int = 0       # 0=CAVLC 1=CABAC
    bottom_field_pic_order: bool = False
    num_slice_groups: int = 1
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = False
    constrained_intra_pred: bool = False
    redundant_pic_cnt_present: bool = False
    transform_8x8_mode: bool = False
    pic_scaling_matrix_present: bool = False
    second_chroma_qp_index_offset: Optional[int] = None

    def chroma_qp_offset(self, plane: int) -> int:
        if plane == 1 and self.second_chroma_qp_index_offset is not None:
            return self.second_chroma_qp_index_offset
        return self.chroma_qp_index_offset


def _more_rbsp_data(rbsp: bytes, br: BitReader) -> bool:
    """True while bits before the rbsp_stop_one_bit remain (spec 7.2)."""
    # locate the last set bit of the rbsp (the stop bit)
    last = len(rbsp) - 1
    while last >= 0 and rbsp[last] == 0:
        last -= 1
    if last < 0:
        return False
    b = rbsp[last]
    low = 0
    while not (b >> low) & 1:
        low += 1
    stop_bitpos = last * 8 + (7 - low)
    cur_bitpos = len(rbsp) * 8 - br.bits_remaining()
    return cur_bitpos < stop_bitpos


def parse_pps(nal: bytes, sps_map: Dict[int, SPS]) -> PPS:
    """(spec 7.3.2.2)."""
    rbsp = unescape_rbsp(nal[1:])
    br = BitReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = br.read_ue()
    p.seq_parameter_set_id = br.read_ue()
    p.entropy_coding_mode = int(br.read_flag())
    p.bottom_field_pic_order = br.read_flag()
    p.num_slice_groups = br.read_ue() + 1
    if p.num_slice_groups > 1:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "slice groups (FMO) not supported")
    p.num_ref_idx_l0 = br.read_ue() + 1
    p.num_ref_idx_l1 = br.read_ue() + 1
    p.weighted_pred = br.read_flag()
    p.weighted_bipred_idc = br.read_bits(2)
    p.pic_init_qp = br.read_se() + 26
    p.pic_init_qs = br.read_se() + 26
    p.chroma_qp_index_offset = br.read_se()
    p.deblocking_filter_control_present = br.read_flag()
    p.constrained_intra_pred = br.read_flag()
    p.redundant_pic_cnt_present = br.read_flag()
    if _more_rbsp_data(rbsp, br):  # high profile extension fields
        p.transform_8x8_mode = br.read_flag()
        p.pic_scaling_matrix_present = br.read_flag()
        if p.pic_scaling_matrix_present:
            sps = sps_map.get(p.seq_parameter_set_id)
            n8 = (2 if sps is None or sps.chroma_format_idc != 3 else 6) * \
                int(p.transform_8x8_mode)
            _parse_scaling_matrices(br, SPS(), n8)  # parsed, flat assumed
        p.second_chroma_qp_index_offset = br.read_se()
    return p


# --------------------------------------------------------------------------
# slice header (I slices)
# --------------------------------------------------------------------------

@dataclass
class SliceHeader:
    first_mb: int = 0
    slice_type: int = 2     # %5: 0 = P, 2 = I
    pps_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    poc_lsb: int = 0
    num_ref_idx_l0: int = 1
    ref_idx_reorder: Optional[List[tuple]] = None  # (mod_op, value)
    nal_ref_idc: int = 1
    qp: int = 26
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset: int = 0
    slice_beta_offset: int = 0
    cabac_init_idc: int = 0
    header_bits: int = 0    # position after the header, in bits

    @property
    def is_p(self) -> bool:
        return self.slice_type % 5 == 0


def parse_slice_header(nal: bytes, sps_map: Dict[int, SPS],
                       pps_map: Dict[int, PPS]):
    """Parse an I/P slice header (spec 7.3.3). Returns (hdr, sps, pps,
    rbsp bytes)."""
    nt = nal_type(nal)
    rbsp = unescape_rbsp(nal[1:])
    br = BitReader(rbsp)
    h = SliceHeader()
    h.nal_ref_idc = (nal[0] >> 5) & 3
    h.first_mb = br.read_ue()
    h.slice_type = br.read_ue()
    if h.slice_type % 5 not in (0, 2):
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"only I/P slices supported (got slice_type {h.slice_type})")
    h.pps_id = br.read_ue()
    pps = pps_map.get(h.pps_id)
    if pps is None:
        raise HeifError.invalid_input(msg=f"missing PPS {h.pps_id}")
    sps = sps_map.get(pps.seq_parameter_set_id)
    if sps is None:
        raise HeifError.invalid_input(msg="missing SPS")
    if sps.separate_colour_plane:
        br.read_bits(2)  # colour_plane_id
    h.frame_num = br.read_bits(sps.log2_max_frame_num)
    if not sps.frame_mbs_only:
        if br.read_flag():  # field_pic_flag
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "field pictures not supported")
    if nt == NAL_SLICE_IDR:
        h.idr_pic_id = br.read_ue()
    if sps.pic_order_cnt_type == 0:
        h.poc_lsb = br.read_bits(sps.log2_max_poc_lsb)
        if pps.bottom_field_pic_order:
            br.read_se()
    elif sps.pic_order_cnt_type == 1:
        pass  # delta_pic_order_cnt not present without the flag parse
    if pps.redundant_pic_cnt_present:
        br.read_ue()
    if h.is_p:
        if br.read_flag():  # num_ref_idx_active_override
            h.num_ref_idx_l0 = br.read_ue() + 1
        else:
            h.num_ref_idx_l0 = pps.num_ref_idx_l0
        # ref_pic_list_modification (spec 7.3.3.1)
        if br.read_flag():
            mods = []
            while True:
                op = br.read_ue()
                if op == 3:
                    break
                mods.append((op, br.read_ue()))
            h.ref_idx_reorder = mods
        if pps.weighted_pred:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "weighted prediction (AVC)")
    if nt == NAL_SLICE_IDR:
        br.read_flag()  # no_output_of_prior_pics
        br.read_flag()  # long_term_reference
    elif h.nal_ref_idc != 0:
        if br.read_flag():  # adaptive_ref_pic_marking
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "adaptive ref pic marking")
    if pps.entropy_coding_mode and h.is_p:
        h.cabac_init_idc = br.read_ue()
        if h.cabac_init_idc > 2:
            raise HeifError.invalid_input(msg="cabac_init_idc > 2")
    h.qp = pps.pic_init_qp + br.read_se()
    if pps.deblocking_filter_control_present:
        h.disable_deblocking_filter_idc = br.read_ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset = br.read_se() * 2
            h.slice_beta_offset = br.read_se() * 2
    h.header_bits = (len(rbsp) * 8) - br.bits_remaining()
    return h, sps, pps, rbsp
