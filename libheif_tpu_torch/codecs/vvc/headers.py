"""H.266 parameter sets, picture header and slice header (host side).

Covers the intra-only toolset this package emits (see tables.py
docstring): every optional SPS tool disabled, pps_no_pic_partition,
picture header embedded in the slice header.  Field ordering follows
JVET-S2001 §7.3.2 as reconstructed without the spec text available in
this environment; writer and parser are exact inverses and are locked
by round-trip tests (tests/test_torch_vvc_codec.py).

Replaces the reference's vvdec plugin boundary (ref:
libheif/plugins/decoder_vvdec.cc, libheif/codecs/vvc_dec.cc).

The port's copy of libheif_tpu/codecs/vvc/headers.py, on the port's
core/bitstream.py and boxes/codec_cfg.remove_emulation_prevention; a
NAL handed over as a memoryview (an item payload of one extent) parses
as the same bytes would.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ...core.bitstream import BitReader, BitWriter
from ...core.error import HeifError, SubError
from ...boxes.codec_cfg import remove_emulation_prevention

# NAL unit types (H.266 Table 5)
NAL_TRAIL = 0
NAL_IDR_W_RADL = 7
NAL_IDR_N_LP = 8
NAL_CRA = 9
NAL_GDR = 10
NAL_VPS = 14
NAL_SPS = 15
NAL_PPS = 16
NAL_PREFIX_APS = 17
NAL_SUFFIX_APS = 18
NAL_PH = 19
NAL_AUD = 20


def nal_type(nal: bytes) -> int:
    """nal_unit_type from the 2-byte VVC NAL header (§7.3.1.2)."""
    return (nal[1] >> 3) & 0x1F


def is_slice(t: int) -> bool:
    return t <= 12   # VCL range (0..12)


def is_irap(t: int) -> bool:
    return NAL_IDR_W_RADL <= t <= NAL_CRA


def nal_header(nal_unit_type: int, temporal_id: int = 0) -> bytes:
    return bytes([0x00, ((nal_unit_type & 0x1F) << 3) |
                  ((temporal_id + 1) & 0x7)])


# --------------------------------------------------------------------------
# ue(v)/se(v) helpers over the shared BitReader/BitWriter
# --------------------------------------------------------------------------

def write_ue(w: BitWriter, v: int) -> None:
    n = v + 1
    nbits = n.bit_length()
    w.write_bits(0, nbits - 1)
    w.write_bits(n, nbits)


def write_se(w: BitWriter, v: int) -> None:
    write_ue(w, 2 * v - 1 if v > 0 else -2 * v)


def rbsp_trailing(w: BitWriter) -> None:
    w.write_bits(1, 1)
    while w.bit_position % 8:
        w.write_bits(0, 1)


def add_emulation_prevention(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# --------------------------------------------------------------------------
# Parameter set models
# --------------------------------------------------------------------------

@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sublayers: int = 1
    chroma_format_idc: int = 1
    log2_ctu_size: int = 5            # CTU 32 (sps_log2_ctu_size_minus5=0)
    profile_idc: int = 1              # Main 10
    tier_flag: int = 0
    level_idc: int = 67               # 4.1
    pic_width: int = 0                # max coded size (CTU multiple not req.)
    pic_height: int = 0
    conf_win: Tuple[int, int, int, int] = (0, 0, 0, 0)   # l, r, t, b
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    log2_min_cb_size: int = 3         # min CB 8
    log2_diff_min_qt_min_cb_intra: int = 0
    max_mtt_depth_intra: int = 0
    log2_diff_max_bt_min_qt: int = 0
    log2_diff_max_tt_min_qt: int = 0
    dual_tree_intra: bool = False
    mip_enabled: bool = False
    isp_enabled: bool = False
    lfnst_enabled: bool = False
    # chroma QP table signalling (identity):
    qp_table_start_minus26: int = 0
    qp_table_points: Tuple[Tuple[int, int], ...] = ((0, 0),)

    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_ctu_size

    @property
    def min_qt_log2(self) -> int:
        return self.log2_min_cb_size + self.log2_diff_min_qt_min_cb_intra

    @property
    def max_bt_log2(self) -> int:
        return self.min_qt_log2 + self.log2_diff_max_bt_min_qt

    @property
    def max_tt_log2(self) -> int:
        return self.min_qt_log2 + self.log2_diff_max_tt_min_qt

    @property
    def cropped_size(self) -> Tuple[int, int]:
        l, r, t, b = self.conf_win
        sw = 2 if self.chroma_format_idc in (1, 2) else 1
        sh = 2 if self.chroma_format_idc == 1 else 1
        return (self.pic_width - sw * (l + r),
                self.pic_height - sh * (t + b))


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    pic_width: int = 0
    pic_height: int = 0
    init_qp: int = 26
    deblocking_disabled: bool = True


@dataclass
class SliceHeader:
    slice_type: int = 2               # I
    pps_id: int = 0
    qp: int = 26
    data_offset_bits: int = 0         # CABAC start within the RBSP


# --------------------------------------------------------------------------
# profile_tier_level (§7.3.3.1) — profileTierPresent=1, 0 sublayers
# --------------------------------------------------------------------------

def _write_ptl(w: BitWriter, sps: SPS) -> None:
    w.write_bits(sps.profile_idc, 7)
    w.write_bits(sps.tier_flag, 1)
    w.write_bits(sps.level_idc, 8)
    w.write_bits(1, 1)                # ptl_frame_only_constraint_flag
    w.write_bits(0, 1)                # ptl_multilayer_enabled_flag
    w.write_bits(0, 1)                # gci_present_flag
    while w.bit_position % 8:              # gci alignment
        w.write_bits(0, 1)
    # no sublayer level flags (max_sublayers==1); already byte aligned
    w.write_bits(0, 8)                # ptl_num_sub_profiles


def _parse_ptl(br: BitReader, sps: SPS) -> None:
    sps.profile_idc = br.read_bits(7)
    sps.tier_flag = br.read_bits(1)
    sps.level_idc = br.read_bits(8)
    br.read_bits(2)                   # frame_only, multilayer
    gci_present = br.read_bits(1)
    if gci_present:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "VVC general constraints info")
    while br.bit_position % 8:
        br.read_bits(1)
    n_sub = br.read_bits(8)
    for _ in range(n_sub):
        br.read_bits(32)


# --------------------------------------------------------------------------
# SPS (§7.3.2.3)
# --------------------------------------------------------------------------

def write_sps(sps: SPS) -> bytes:
    w = BitWriter()
    w.write_bits(sps.sps_id, 4)
    w.write_bits(sps.vps_id, 4)
    w.write_bits(sps.max_sublayers - 1, 3)
    w.write_bits(sps.chroma_format_idc, 2)
    w.write_bits(sps.log2_ctu_size - 5, 2)
    w.write_bits(1, 1)                      # sps_ptl_dpb_hrd_params_present
    _write_ptl(w, sps)
    w.write_bits(0, 1)                      # sps_gdr_enabled_flag
    w.write_bits(0, 1)                      # sps_ref_pic_resampling_enabled
    write_ue(w, sps.pic_width)
    write_ue(w, sps.pic_height)
    have_win = any(sps.conf_win)
    w.write_bits(1 if have_win else 0, 1)   # sps_conformance_window_flag
    if have_win:
        l, r, t, b = sps.conf_win
        for v in (l, r, t, b):
            write_ue(w, v)
    w.write_bits(0, 1)                      # sps_subpic_info_present_flag
    write_ue(w, sps.bit_depth - 8)
    w.write_bits(0, 1)                      # sps_entropy_coding_sync_enabled
    w.write_bits(0, 1)                      # sps_entry_point_offsets_present
    w.write_bits(sps.log2_max_poc_lsb - 4, 4)
    w.write_bits(0, 1)                      # sps_poc_msb_cycle_flag
    w.write_bits(0, 2)                      # sps_num_extra_ph_bytes
    w.write_bits(0, 2)                      # sps_num_extra_sh_bytes
    # dpb_parameters (ptl_dpb_hrd present, single sublayer)
    write_ue(w, 0)                          # dpb_max_dec_pic_buffering_minus1
    write_ue(w, 0)                          # dpb_max_num_reorder_pics
    write_ue(w, 0)                          # dpb_max_latency_increase_plus1
    write_ue(w, sps.log2_min_cb_size - 2)
    w.write_bits(0, 1)                      # partition_constraints_override
    write_ue(w, sps.log2_diff_min_qt_min_cb_intra)
    write_ue(w, sps.max_mtt_depth_intra)
    if sps.max_mtt_depth_intra:
        write_ue(w, sps.log2_diff_max_bt_min_qt)
        write_ue(w, sps.log2_diff_max_tt_min_qt)
    if sps.chroma_format_idc:
        w.write_bits(1 if sps.dual_tree_intra else 0, 1)
        if sps.dual_tree_intra:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "dual tree intra")
    write_ue(w, 0)                          # log2_diff_min_qt_min_cb_inter
    write_ue(w, 0)                          # max_mtt_hierarchy_depth_inter
    if sps.ctu_size > 32:
        w.write_bits(0, 1)                  # sps_max_luma_transform_size_64
    w.write_bits(0, 1)                      # sps_transform_skip_enabled_flag
    w.write_bits(0, 1)                      # sps_mts_enabled_flag
    w.write_bits(1 if sps.lfnst_enabled else 0, 1)  # sps_lfnst_enabled_flag
    if sps.chroma_format_idc:
        w.write_bits(0, 1)                  # sps_joint_cbcr_enabled_flag
        w.write_bits(1, 1)                  # sps_same_qp_table_for_chroma
        write_se(w, sps.qp_table_start_minus26)
        write_ue(w, len(sps.qp_table_points) - 1)
        for d_in, d_diff in sps.qp_table_points:
            write_ue(w, d_in)
            write_ue(w, d_diff)
    w.write_bits(0, 1)                      # sps_sao_enabled_flag
    w.write_bits(0, 1)                      # sps_alf_enabled_flag
    w.write_bits(0, 1)                      # sps_lmcs_enabled_flag
    w.write_bits(0, 1)                      # sps_weighted_pred_flag
    w.write_bits(0, 1)                      # sps_weighted_bipred_flag
    w.write_bits(0, 1)                      # sps_long_term_ref_pics_flag
    w.write_bits(0, 1)                      # sps_idr_rpl_present_flag
    w.write_bits(1, 1)                      # sps_rpl1_same_as_rpl0_flag
    write_ue(w, 0)                          # sps_num_ref_pic_lists[0]
    w.write_bits(0, 1)                      # sps_ref_wraparound_enabled_flag
    w.write_bits(0, 1)                      # sps_temporal_mvp_enabled_flag
    w.write_bits(0, 1)                      # sps_amvr_enabled_flag
    w.write_bits(0, 1)                      # sps_bdof_enabled_flag
    w.write_bits(0, 1)                      # sps_smvd_enabled_flag
    w.write_bits(0, 1)                      # sps_dmvr_enabled_flag
    w.write_bits(0, 1)                      # sps_mmvd_enabled_flag
    write_ue(w, 5)                          # six_minus_max_num_merge_cand → 1
    w.write_bits(0, 1)                      # sps_sbt_enabled_flag
    w.write_bits(0, 1)                      # sps_affine_enabled_flag
    w.write_bits(0, 1)                      # sps_bcw_enabled_flag
    w.write_bits(0, 1)                      # sps_ciip_enabled_flag
    write_ue(w, 0)                          # log2_parallel_merge_level_minus2
    w.write_bits(1 if sps.isp_enabled else 0, 1)    # sps_isp_enabled_flag
    w.write_bits(0, 1)                      # sps_mrl_enabled_flag
    w.write_bits(1 if sps.mip_enabled else 0, 1)    # sps_mip_enabled_flag
    if sps.chroma_format_idc:
        w.write_bits(0, 1)                  # sps_cclm_enabled_flag
    if sps.chroma_format_idc == 1:
        w.write_bits(1, 1)                  # chroma_horizontal_collocated
        w.write_bits(1, 1)                  # chroma_vertical_collocated
    w.write_bits(0, 1)                      # sps_palette_enabled_flag
    w.write_bits(0, 1)                      # sps_ibc_enabled_flag
    w.write_bits(0, 1)                      # sps_ladf_enabled_flag
    w.write_bits(0, 1)                      # sps_explicit_scaling_list
    w.write_bits(0, 1)                      # sps_dep_quant_enabled_flag
    w.write_bits(0, 1)                      # sps_sign_data_hiding_enabled
    w.write_bits(0, 1)                      # sps_virtual_boundaries_enabled
    w.write_bits(0, 1)                      # sps_timing_hrd_params_present
    w.write_bits(0, 1)                      # sps_field_seq_flag
    w.write_bits(0, 1)                      # sps_vui_parameters_present_flag
    w.write_bits(0, 1)                      # sps_extension_flag
    rbsp_trailing(w)
    return nal_header(NAL_SPS) + add_emulation_prevention(w.data())


def parse_sps(nal: bytes) -> SPS:
    rbsp = remove_emulation_prevention(nal[2:])
    br = BitReader(rbsp)
    sps = SPS()
    sps.sps_id = br.read_bits(4)
    sps.vps_id = br.read_bits(4)
    sps.max_sublayers = br.read_bits(3) + 1
    sps.chroma_format_idc = br.read_bits(2)
    sps.log2_ctu_size = br.read_bits(2) + 5
    ptl_present = br.read_bits(1)
    if ptl_present:
        _parse_ptl(br, sps)
    gdr = br.read_bits(1)
    ref_resampling = br.read_bits(1)
    if ref_resampling:
        br.read_bits(1)
    sps.pic_width = br.read_ue()
    sps.pic_height = br.read_ue()
    if br.read_bits(1):
        sps.conf_win = (br.read_ue(), br.read_ue(),
                        br.read_ue(), br.read_ue())
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "VVC subpictures")
    sps.bit_depth = br.read_ue() + 8
    wpp = br.read_bits(1)
    entry_points = br.read_bits(1)
    if wpp or entry_points:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "VVC entropy sync / entry points")
    sps.log2_max_poc_lsb = br.read_bits(4) + 4
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "sps_poc_msb_cycle")
    extra_ph = br.read_bits(2)
    extra_sh = br.read_bits(2)
    if extra_ph or extra_sh:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "extra ph/sh bytes")
    if ptl_present:
        for _ in range(3):
            br.read_ue()                    # dpb params (single sublayer)
    sps.log2_min_cb_size = br.read_ue() + 2
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "partition constraints override")
    sps.log2_diff_min_qt_min_cb_intra = br.read_ue()
    sps.max_mtt_depth_intra = br.read_ue()
    if sps.max_mtt_depth_intra:
        sps.log2_diff_max_bt_min_qt = br.read_ue()
        sps.log2_diff_max_tt_min_qt = br.read_ue()
    if sps.chroma_format_idc:
        sps.dual_tree_intra = bool(br.read_bits(1))
        if sps.dual_tree_intra:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "dual tree intra")
    br.read_ue()                            # min_qt_min_cb_inter
    inter_mtt = br.read_ue()
    if inter_mtt:
        br.read_ue()
        br.read_ue()
    if sps.ctu_size > 32:
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "64-point transforms")
    for name in ("transform_skip", "mts"):
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        f"VVC {name}")
    sps.lfnst_enabled = bool(br.read_bits(1))
    if sps.chroma_format_idc:
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "joint CbCr")
        same_qp_table = br.read_bits(1)
        n_tables = 1 if same_qp_table else \
            (3 if False else 2)             # joint cbcr off → 2 when !same
        pts = []
        for _ in range(n_tables):
            sps.qp_table_start_minus26 = br.read_se()
            n_points = br.read_ue() + 1
            pts = [(br.read_ue(), br.read_ue()) for _ in range(n_points)]
        sps.qp_table_points = tuple(pts)
    for name in ("sao", "alf", "lmcs", "weighted_pred", "weighted_bipred",
                 "long_term_ref", "idr_rpl"):
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        f"VVC {name}")
    rpl1_same = br.read_bits(1)
    for _ in range(1 if rpl1_same else 2):
        n_rpl = br.read_ue()
        if n_rpl:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "SPS ref pic lists")
    for name in ("ref_wraparound", "temporal_mvp", "amvr", "bdof", "smvd",
                 "dmvr", "mmvd"):
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        f"VVC {name}")
    br.read_ue()                            # six_minus_max_num_merge_cand
    for name in ("sbt", "affine", "bcw", "ciip"):
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        f"VVC {name}")
    br.read_ue()                            # parallel merge level
    sps.isp_enabled = bool(br.read_bits(1))
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "VVC mrl")
    sps.mip_enabled = bool(br.read_bits(1))
    if sps.chroma_format_idc:
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "CCLM")
    if sps.chroma_format_idc == 1:
        br.read_bits(2)                     # chroma collocated flags
    for name in ("palette", "ibc", "ladf", "explicit_scaling_list",
                 "dep_quant", "sign_data_hiding", "virtual_boundaries",
                 "timing_hrd"):
        if br.read_bits(1):
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        f"VVC {name}")
    br.read_bits(1)                         # field_seq
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec, "VUI")
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "SPS extensions")
    return sps


# --------------------------------------------------------------------------
# PPS (§7.3.2.4)
# --------------------------------------------------------------------------

def write_pps(pps: PPS) -> bytes:
    w = BitWriter()
    w.write_bits(pps.pps_id, 6)
    w.write_bits(pps.sps_id, 4)
    w.write_bits(0, 1)                      # pps_mixed_nalu_types_in_pic
    write_ue(w, pps.pic_width)
    write_ue(w, pps.pic_height)
    w.write_bits(0, 1)                      # pps_conformance_window_flag
    w.write_bits(0, 1)                      # pps_scaling_window_explicit
    w.write_bits(0, 1)                      # pps_output_flag_present_flag
    w.write_bits(1, 1)                      # pps_no_pic_partition_flag
    w.write_bits(0, 1)                      # pps_subpic_id_mapping_present
    w.write_bits(0, 1)                      # pps_cabac_init_present_flag
    write_ue(w, 0)                          # num_ref_idx_default[0]
    write_ue(w, 0)                          # num_ref_idx_default[1]
    w.write_bits(0, 1)                      # pps_rpl1_idx_present_flag
    w.write_bits(0, 1)                      # pps_weighted_pred_flag
    w.write_bits(0, 1)                      # pps_weighted_bipred_flag
    w.write_bits(0, 1)                      # pps_ref_wraparound_enabled
    write_se(w, pps.init_qp - 26)
    w.write_bits(0, 1)                      # pps_cu_qp_delta_enabled_flag
    w.write_bits(0, 1)                      # pps_chroma_tool_offsets_present
    w.write_bits(1, 1)                      # pps_deblocking_filter_control
    w.write_bits(0, 1)                      # dbf_override_enabled
    w.write_bits(1 if pps.deblocking_disabled else 0, 1)
    if not pps.deblocking_disabled:
        for _ in range(6):                  # luma/cb/cr beta & tc offsets
            write_se(w, 0)
    w.write_bits(0, 1)                      # picture_header_extension
    w.write_bits(0, 1)                      # slice_header_extension
    w.write_bits(0, 1)                      # pps_extension_flag
    rbsp_trailing(w)
    return nal_header(NAL_PPS) + add_emulation_prevention(w.data())


def parse_pps(nal: bytes) -> PPS:
    rbsp = remove_emulation_prevention(nal[2:])
    br = BitReader(rbsp)
    pps = PPS()
    pps.pps_id = br.read_bits(6)
    pps.sps_id = br.read_bits(4)
    br.read_bits(1)                         # mixed nalu types
    pps.pic_width = br.read_ue()
    pps.pic_height = br.read_ue()
    if br.read_bits(1):
        for _ in range(4):
            br.read_ue()                    # pps conformance window
    if br.read_bits(1):
        for _ in range(4):
            br.read_se()                    # scaling window
    br.read_bits(1)                         # output_flag_present
    no_partition = br.read_bits(1)
    if not no_partition:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "VVC tiles/slices partitioning")
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "subpic id mapping")
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "cabac_init")
    br.read_ue()
    br.read_ue()
    br.read_bits(4)                         # rpl1_idx, wp, wbp, wraparound
    pps.init_qp = br.read_se() + 26
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "cu_qp_delta")
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "chroma tool offsets")
    if br.read_bits(1):                     # deblocking control present
        override = br.read_bits(1)
        if override:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "deblocking override")
        pps.deblocking_disabled = bool(br.read_bits(1))
        if not pps.deblocking_disabled:
            for _ in range(6):
                br.read_se()
    else:
        pps.deblocking_disabled = False
    br.read_bits(2)                         # ph/sh extension flags
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "PPS extensions")
    return pps


# --------------------------------------------------------------------------
# Slice header with embedded picture header (§7.3.7.1, §7.3.2.8)
# --------------------------------------------------------------------------

def write_slice_header(sps: SPS, pps: PPS, qp: int) -> BitWriter:
    """Returns an open BitWriter positioned at the (byte-aligned) start
    of slice data; the caller appends CABAC bytes."""
    w = BitWriter()
    w.write_bits(1, 1)                      # sh_picture_header_in_slice_header
    # picture_header_structure()
    w.write_bits(1, 1)                      # ph_gdr_or_irap_pic_flag
    w.write_bits(0, 1)                      # ph_non_ref_pic_flag
    w.write_bits(0, 1)                      # ph_gdr_pic_flag
    w.write_bits(0, 1)                      # ph_inter_slice_allowed_flag
    write_ue(w, pps.pps_id)                 # ph_pic_parameter_set_id
    w.write_bits(0, sps.log2_max_poc_lsb)   # ph_pic_order_cnt_lsb
    # end of picture header (all optional blocks disabled by SPS/PPS)
    w.write_bits(0, 1)                      # sh_no_output_of_prior_pics_flag
    write_se(w, qp - pps.init_qp)           # sh_qp_delta
    # byte alignment
    w.write_bits(1, 1)
    while w.bit_position % 8:
        w.write_bits(0, 1)
    return w


def parse_slice_header(nal: bytes, sps: SPS, pps_map) -> SliceHeader:
    t = nal_type(nal)
    rbsp = remove_emulation_prevention(nal[2:])
    br = BitReader(rbsp)
    sh = SliceHeader()
    if not br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "separate picture header NAL")
    if not br.read_bits(1):                 # gdr_or_irap
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "non-IRAP picture")
    br.read_bits(1)                         # non_ref_pic
    if br.read_bits(1):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "GDR picture")
    inter_allowed = br.read_bits(1)
    if inter_allowed:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "inter slices")
    sh.pps_id = br.read_ue()
    if sh.pps_id not in pps_map:
        raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                      "slice references unknown PPS")
    pps = pps_map[sh.pps_id]
    br.read_bits(sps.log2_max_poc_lsb)      # poc lsb
    if is_irap(t):
        br.read_bits(1)                     # no_output_of_prior_pics
    sh.slice_type = 2
    sh.qp = pps.init_qp + br.read_se()
    if not (0 <= sh.qp <= 63):
        raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                      f"slice QP {sh.qp} out of range")
    # byte alignment: one 1-bit then zeros
    if not br.read_bits(1):
        raise HeifError.invalid_input(msg="bad slice header alignment")
    while br.bit_position % 8:
        br.read_bits(1)
    sh.data_offset_bits = br.bit_position
    return sh
