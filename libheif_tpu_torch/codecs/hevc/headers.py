"""H.265 parameter sets and slice segment header (host side).

Counterpart of libheif_tpu/codecs/hevc/headers.py:18-635: full SPS
(§7.3.2.2), PPS (§7.3.2.3) and slice segment header (§7.3.6) parsing.
The scaling lists are parsed and turned into the ScalingFactor matrices
in effect (``effective_scaling_factors``, JAX headers.py:258-303,
:636-649).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...core.bitstream import BitReader
from ...core.error import HeifError, SubError
from ...boxes.codec_cfg import remove_emulation_prevention

NAL_TRAIL_N = 0
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_SUFFIX_SEI = 40


def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


def is_irap(t: int) -> bool:
    return 16 <= t <= 23


def is_slice(t: int) -> bool:
    return t <= 31


@dataclass
class ShortTermRPS:
    num_negative: int = 0
    num_positive: int = 0
    delta_poc_s0: List[int] = field(default_factory=list)
    used_s0: List[bool] = field(default_factory=list)
    delta_poc_s1: List[int] = field(default_factory=list)
    used_s1: List[bool] = field(default_factory=list)


@dataclass
class SPS:
    vps_id: int = 0
    max_sub_layers: int = 1
    profile_idc: int = 1
    level_idc: int = 0
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: bool = False
    pic_width: int = 0
    pic_height: int = 0
    conf_win: tuple = (0, 0, 0, 0)  # l, r, t, b
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_pic_order_cnt_lsb: int = 8
    max_num_reorder_pics: int = 0      # highest sub-layer value (§7.4.3.2.1)
    # coding structure
    log2_min_cb_size: int = 3          # log2_min_luma_coding_block_size
    log2_ctb_size: int = 6
    log2_min_tb_size: int = 2
    log2_max_tb_size: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: bool = False
    scaling_parsed: Optional[tuple] = None   # (lists, dcs) when coded
    amp_enabled: bool = False
    sample_adaptive_offset_enabled: bool = False
    pcm_enabled: bool = False
    pcm_bit_depth_luma: int = 8
    pcm_bit_depth_chroma: int = 8
    log2_min_pcm_cb_size: int = 3
    log2_max_pcm_cb_size: int = 3
    pcm_loop_filter_disabled: bool = False
    num_short_term_rps: int = 0
    short_term_rps: List[ShortTermRPS] = field(default_factory=list)
    long_term_ref_pics_present: bool = False
    temporal_mvp_enabled: bool = False
    strong_intra_smoothing: bool = False

    # derived
    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb_size

    @property
    def pic_width_in_ctbs(self) -> int:
        return (self.pic_width + self.ctb_size - 1) >> self.log2_ctb_size

    @property
    def pic_height_in_ctbs(self) -> int:
        return (self.pic_height + self.ctb_size - 1) >> self.log2_ctb_size

    @property
    def cropped_size(self):
        sub_w = 2 if self.chroma_format_idc in (1, 2) else 1
        sub_h = 2 if self.chroma_format_idc == 1 else 1
        l, r, t, b = self.conf_win
        return (self.pic_width - sub_w * (l + r),
                self.pic_height - sub_h * (t + b))


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: bool = False
    output_flag_present: bool = False
    num_extra_slice_header_bits: int = 0
    sign_data_hiding_enabled: bool = False
    cabac_init_present: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass_enabled: bool = False
    tiles_enabled: bool = False
    entropy_coding_sync_enabled: bool = False
    num_tile_columns: int = 1
    num_tile_rows: int = 1
    uniform_spacing: bool = True
    column_widths: List[int] = field(default_factory=list)  # in CTBs
    row_heights: List[int] = field(default_factory=list)
    loop_filter_across_tiles: bool = True
    loop_filter_across_slices: bool = False
    deblocking_filter_control_present: bool = False
    deblocking_filter_override_enabled: bool = False
    deblocking_filter_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    scaling_list_data_present: bool = False
    scaling_parsed: Optional[tuple] = None
    lists_modification_present: bool = False
    log2_parallel_merge_level: int = 2
    slice_segment_header_extension_present: bool = False


@dataclass
class SliceHeader:
    first_slice_in_pic: bool = True
    pps_id: int = 0
    dependent_slice: bool = False
    segment_address: int = 0
    slice_type: int = 2               # 0=B 1=P 2=I
    pic_output_flag: bool = True
    sao_luma: bool = False
    sao_chroma: bool = False
    # inter (P/B) fields
    poc_lsb: int = 0
    rps: Optional["ShortTermRPS"] = None
    temporal_mvp: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    rplm_l0: Optional[List[int]] = None   # explicit list-0 reordering
    rplm_l1: Optional[List[int]] = None   # explicit list-1 reordering (B)
    mvd_l1_zero: bool = False             # B: list-1 MVDs inferred zero
    cabac_init_flag: bool = False
    max_num_merge_cand: int = 5
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    deblocking_filter_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: bool = False
    num_entry_points: int = 0
    entry_point_offsets: List[int] = field(default_factory=list)
    data_offset_bits: int = 0          # bit position where slice data starts


def _profile_tier_level(br: BitReader, max_sub_layers: int) -> tuple:
    br.read_bits(2)                    # profile_space
    br.read_bits(1)                    # tier
    profile_idc = br.read_bits(5)
    br.read_bits(32)                   # compatibility flags
    br.read_bits(32)
    br.read_bits(16)                   # constraint flags (48 bits total)
    level_idc = br.read_bits(8)
    sub_profile = []
    sub_level = []
    for _ in range(max_sub_layers - 1):
        sub_profile.append(br.read_flag())
        sub_level.append(br.read_flag())
    if max_sub_layers > 1:
        br.skip_bits(2 * (8 - (max_sub_layers - 1)))
    for i in range(max_sub_layers - 1):
        if sub_profile[i]:
            br.skip_bits(2 + 1 + 5 + 32 + 48)
        if sub_level[i]:
            br.skip_bits(8)
    return profile_idc, level_idc


def _scaling_list_data(br: BitReader):
    """Parse scaling_list_data (§7.3.4) → (lists, dcs):
    lists[size_id][matrix_id] = coefficient list in diagonal-scan
    order; dcs[size_id][matrix_id] for size_id >= 2."""
    from .tables import (DEFAULT_SCALING_INTRA_DIAG,
                         DEFAULT_SCALING_INTER_DIAG)
    lists = [[None] * 6 for _ in range(4)]
    dcs = [[16] * 6 for _ in range(4)]
    for size_id in range(4):
        mids = (0, 3) if size_id == 3 else (0, 1, 2, 3, 4, 5)
        for matrix_id in mids:
            pred_mode = br.read_flag()
            if not pred_mode:
                delta = br.read_ue()
                if delta == 0:
                    lists[size_id][matrix_id] = _default_scaling(
                        size_id, matrix_id,
                        DEFAULT_SCALING_INTRA_DIAG,
                        DEFAULT_SCALING_INTER_DIAG)
                    dcs[size_id][matrix_id] = 16
                else:
                    ref = matrix_id - delta * (3 if size_id == 3 else 1)
                    lists[size_id][matrix_id] = \
                        list(lists[size_id][ref])
                    dcs[size_id][matrix_id] = dcs[size_id][ref]
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                if size_id > 1:
                    dcs[size_id][matrix_id] = br.read_se() + 8
                    next_coef = dcs[size_id][matrix_id]
                coefs = []
                for _ in range(coef_num):
                    next_coef = (next_coef + br.read_se() + 256) % 256
                    coefs.append(next_coef)
                lists[size_id][matrix_id] = coefs
    return lists, dcs


def _default_scaling(size_id: int, matrix_id: int, intra_diag,
                     inter_diag) -> List[int]:
    if size_id == 0:
        return [16] * 16
    return list(intra_diag if matrix_id < 3 else inter_diag)



def build_scaling_factors(parsed):
    """ScalingFactor derivation (spec 7.4.5) → factors[log2 - 2], a list of
    6 (n, n) int32 arrays indexed [y][x]; ``parsed`` = (lists, dcs) from
    _scaling_list_data, or None for the all-default matrices."""
    import numpy as np
    from .tables import (diag_scan, DEFAULT_SCALING_INTRA_DIAG,
                         DEFAULT_SCALING_INTER_DIAG)
    if parsed is None:
        lists = [[_default_scaling(s, m, DEFAULT_SCALING_INTRA_DIAG,
                                   DEFAULT_SCALING_INTER_DIAG)
                  for m in range(6)] for s in range(4)]
        dcs = [[16] * 6 for _ in range(4)]
    else:
        lists = [list(row) for row in parsed[0]]
        dcs = [list(row) for row in parsed[1]]
        # size 3 carries only matrix ids 0 and 3; mirror for lookup
        for m in (1, 2):
            if lists[3][m] is None and lists[3][0] is not None:
                lists[3][m] = lists[3][0]
                dcs[3][m] = dcs[3][0]
            if lists[3][m + 3] is None and lists[3][3] is not None:
                lists[3][m + 3] = lists[3][3]
                dcs[3][m + 3] = dcs[3][3]
    out = []
    for size_id in range(4):
        n = 4 << size_id
        base = 4 if size_id == 0 else 8
        scan = diag_scan(base)
        mats = []
        for matrix_id in range(6):
            lst = lists[size_id][matrix_id]
            if lst is None:
                lst = _default_scaling(size_id, matrix_id,
                                       DEFAULT_SCALING_INTRA_DIAG,
                                       DEFAULT_SCALING_INTER_DIAG)
            m8 = np.zeros((base, base), np.int32)
            for i, v in enumerate(lst):
                m8[int(scan[i][1]), int(scan[i][0])] = v
            if size_id <= 1:
                mat = m8
            else:
                rep = n // base
                mat = np.repeat(np.repeat(m8, rep, 0), rep, 1)
                mat[0, 0] = dcs[size_id][matrix_id]
            mats.append(mat)
        out.append(mats)
    return out


def effective_scaling_factors(sps, pps):
    """ScalingFactor matrices in effect (spec 7.4.5 precedence: PPS data,
    then SPS data, then the defaults), or None when scaling lists are off.
    Cached on the SPS, keyed on the parsed list objects themselves (held
    by the cache, so a new PPS can never meet a stale entry)."""
    if not sps.scaling_list_enabled:
        return None
    parsed = pps.scaling_parsed if pps.scaling_parsed is not None \
        else sps.scaling_parsed
    cached = getattr(sps, "_sf_cache", None)
    if cached is not None and cached[0] is parsed:
        return cached[1]
    f = build_scaling_factors(parsed)
    sps._sf_cache = (parsed, f)
    return f


def _short_term_rps(br: BitReader, idx: int, rps_list: List[ShortTermRPS],
                    num_rps: int = -1) -> ShortTermRPS:
    """Parse one short_term_ref_pic_set (spec 7.3.7/7.4.8), including
    full reconstruction of delta-coded sets (needed for P reference
    list building).  `num_rps` is sps.num_short_term_rps when parsing
    the slice-level set (idx == num_rps allows delta_idx_minus1)."""
    rps = ShortTermRPS()
    inter_pred = br.read_flag() if idx != 0 else False
    if inter_pred:
        delta_idx = 1
        if num_rps >= 0 and idx == num_rps:
            delta_idx = br.read_ue() + 1
        sign = br.read_flag()
        abs_delta = br.read_ue() + 1
        delta_rps = -abs_delta if sign else abs_delta
        ref = rps_list[idx - delta_idx]
        n = ref.num_negative + ref.num_positive
        used = []
        use_delta = []
        for _ in range(n + 1):
            u = br.read_flag()
            used.append(u)
            use_delta.append(br.read_flag() if not u else True)
        # spec 7.4.8: derive the new set in cumulative POC-delta space
        ds0 = []
        acc = 0
        for d in ref.delta_poc_s0:
            acc -= d
            ds0.append(acc)
        ds1 = []
        acc = 0
        for d in ref.delta_poc_s1:
            acc += d
            ds1.append(acc)
        new_s0 = []
        for j in range(ref.num_positive - 1, -1, -1):
            d_poc = ds1[j] + delta_rps
            if d_poc < 0 and use_delta[ref.num_negative + j]:
                new_s0.append((d_poc, used[ref.num_negative + j]))
        if delta_rps < 0 and use_delta[n]:
            new_s0.append((delta_rps, used[n]))
        for j in range(ref.num_negative):
            d_poc = ds0[j] + delta_rps
            if d_poc < 0 and use_delta[j]:
                new_s0.append((d_poc, used[j]))
        new_s1 = []
        for j in range(ref.num_negative - 1, -1, -1):
            d_poc = ds0[j] + delta_rps
            if d_poc > 0 and use_delta[j]:
                new_s1.append((d_poc, used[j]))
        if delta_rps > 0 and use_delta[n]:
            new_s1.append((delta_rps, used[n]))
        for j in range(ref.num_positive):
            d_poc = ds1[j] + delta_rps
            if d_poc > 0 and use_delta[ref.num_negative + j]:
                new_s1.append((d_poc, used[ref.num_negative + j]))
        rps.num_negative = len(new_s0)
        rps.num_positive = len(new_s1)
        prev = 0
        for d_poc, u in new_s0:
            rps.delta_poc_s0.append(prev - d_poc)
            rps.used_s0.append(u)
            prev = d_poc
        prev = 0
        for d_poc, u in new_s1:
            rps.delta_poc_s1.append(d_poc - prev)
            rps.used_s1.append(u)
            prev = d_poc
    else:
        rps.num_negative = br.read_ue()
        rps.num_positive = br.read_ue()
        for _ in range(rps.num_negative):
            rps.delta_poc_s0.append(br.read_ue() + 1)
            rps.used_s0.append(br.read_flag())
        for _ in range(rps.num_positive):
            rps.delta_poc_s1.append(br.read_ue() + 1)
            rps.used_s1.append(br.read_flag())
    return rps


def parse_sps(nal: bytes) -> SPS:
    rbsp = remove_emulation_prevention(nal[2:])
    br = BitReader(rbsp)
    s = SPS()
    s.vps_id = br.read_bits(4)
    s.max_sub_layers = br.read_bits(3) + 1
    br.read_bits(1)  # temporal_id_nesting
    s.profile_idc, s.level_idc = _profile_tier_level(br, s.max_sub_layers)
    s.sps_id = br.read_ue()
    s.chroma_format_idc = br.read_ue()
    if s.chroma_format_idc == 3:
        s.separate_colour_plane = br.read_flag()
    s.pic_width = br.read_ue()
    s.pic_height = br.read_ue()
    if br.read_flag():  # conformance window
        s.conf_win = (br.read_ue(), br.read_ue(), br.read_ue(), br.read_ue())
    s.bit_depth_luma = br.read_ue() + 8
    s.bit_depth_chroma = br.read_ue() + 8
    s.log2_max_pic_order_cnt_lsb = br.read_ue() + 4
    sub_layer_ordering = br.read_flag()
    n_ord = s.max_sub_layers if sub_layer_ordering else 1
    for _ in range(n_ord):
        br.read_ue()  # max_dec_pic_buffering
        s.max_num_reorder_pics = br.read_ue()  # num_reorder_pics
        br.read_ue()  # max_latency_increase
    s.log2_min_cb_size = br.read_ue() + 3
    s.log2_ctb_size = s.log2_min_cb_size + br.read_ue()
    s.log2_min_tb_size = br.read_ue() + 2
    s.log2_max_tb_size = s.log2_min_tb_size + br.read_ue()
    s.max_transform_hierarchy_depth_inter = br.read_ue()
    s.max_transform_hierarchy_depth_intra = br.read_ue()
    s.scaling_list_enabled = br.read_flag()
    if s.scaling_list_enabled:
        if br.read_flag():  # sps_scaling_list_data_present
            s.scaling_parsed = _scaling_list_data(br)
    s.amp_enabled = br.read_flag()
    s.sample_adaptive_offset_enabled = br.read_flag()
    s.pcm_enabled = br.read_flag()
    if s.pcm_enabled:
        s.pcm_bit_depth_luma = br.read_bits(4) + 1
        s.pcm_bit_depth_chroma = br.read_bits(4) + 1
        s.log2_min_pcm_cb_size = br.read_ue() + 3
        s.log2_max_pcm_cb_size = s.log2_min_pcm_cb_size + br.read_ue()
        s.pcm_loop_filter_disabled = br.read_flag()
    s.num_short_term_rps = br.read_ue()
    for i in range(s.num_short_term_rps):
        s.short_term_rps.append(_short_term_rps(br, i, s.short_term_rps))
    s.long_term_ref_pics_present = br.read_flag()
    if s.long_term_ref_pics_present:
        n = br.read_ue()
        for _ in range(n):
            br.read_bits(s.log2_max_pic_order_cnt_lsb)
            br.read_flag()
    s.temporal_mvp_enabled = br.read_flag()
    s.strong_intra_smoothing = br.read_flag()
    # vui/extensions ignored
    return s


def parse_pps(nal: bytes) -> PPS:
    rbsp = remove_emulation_prevention(nal[2:])
    br = BitReader(rbsp)
    p = PPS()
    p.pps_id = br.read_ue()
    p.sps_id = br.read_ue()
    p.dependent_slice_segments_enabled = br.read_flag()
    p.output_flag_present = br.read_flag()
    p.num_extra_slice_header_bits = br.read_bits(3)
    p.sign_data_hiding_enabled = br.read_flag()
    p.cabac_init_present = br.read_flag()
    p.num_ref_idx_l0_default = br.read_ue() + 1
    p.num_ref_idx_l1_default = br.read_ue() + 1
    p.init_qp = br.read_se() + 26
    p.constrained_intra_pred = br.read_flag()
    p.transform_skip_enabled = br.read_flag()
    p.cu_qp_delta_enabled = br.read_flag()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = br.read_ue()
    p.cb_qp_offset = br.read_se()
    p.cr_qp_offset = br.read_se()
    p.slice_chroma_qp_offsets_present = br.read_flag()
    p.weighted_pred = br.read_flag()
    p.weighted_bipred = br.read_flag()
    p.transquant_bypass_enabled = br.read_flag()
    p.tiles_enabled = br.read_flag()
    p.entropy_coding_sync_enabled = br.read_flag()
    if p.tiles_enabled:
        p.num_tile_columns = br.read_ue() + 1
        p.num_tile_rows = br.read_ue() + 1
        p.uniform_spacing = br.read_flag()
        if not p.uniform_spacing:
            p.column_widths = [br.read_ue() + 1
                               for _ in range(p.num_tile_columns - 1)]
            p.row_heights = [br.read_ue() + 1
                             for _ in range(p.num_tile_rows - 1)]
        p.loop_filter_across_tiles = br.read_flag()
    p.loop_filter_across_slices = br.read_flag()
    p.deblocking_filter_control_present = br.read_flag()
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = br.read_flag()
        p.deblocking_filter_disabled = br.read_flag()
        if not p.deblocking_filter_disabled:
            p.beta_offset_div2 = br.read_se()
            p.tc_offset_div2 = br.read_se()
    p.scaling_list_data_present = br.read_flag()
    if p.scaling_list_data_present:
        p.scaling_parsed = _scaling_list_data(br)
    p.lists_modification_present = br.read_flag()
    p.log2_parallel_merge_level = br.read_ue() + 2
    p.slice_segment_header_extension_present = br.read_flag()
    return p


def parse_slice_header(nal: bytes, sps: SPS, pps_map) -> SliceHeader:
    """Parse an (I-)slice segment header; returns header with the bit
    offset where slice data begins (after byte alignment)."""
    t = nal_type(nal)
    rbsp = remove_emulation_prevention(nal[2:])
    br = BitReader(rbsp)
    h = SliceHeader()
    h.first_slice_in_pic = br.read_flag()
    if is_irap(t):
        br.read_flag()  # no_output_of_prior_pics
    h.pps_id = br.read_ue()
    pps = pps_map.get(h.pps_id)
    if pps is None:
        raise HeifError.invalid_input(
            msg=f"slice references unknown PPS {h.pps_id}")
    if not h.first_slice_in_pic:
        if pps.dependent_slice_segments_enabled:
            h.dependent_slice = br.read_flag()
        import math
        ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        bits = max(1, math.ceil(math.log2(max(ctbs, 2))))
        h.segment_address = br.read_bits(bits)
    if not h.dependent_slice:
        br.skip_bits(pps.num_extra_slice_header_bits)
        h.slice_type = br.read_ue()
        if pps.output_flag_present:
            h.pic_output_flag = br.read_flag()
        if sps.separate_colour_plane:
            br.read_bits(2)
        if not (t in (19, 20)):  # not IDR: poc etc.
            h.poc_lsb = br.read_bits(sps.log2_max_pic_order_cnt_lsb)
            if not br.read_flag():  # short_term_ref_pic_set_sps_flag
                h.rps = _short_term_rps(br, sps.num_short_term_rps,
                                        sps.short_term_rps,
                                        sps.num_short_term_rps)
            else:
                ridx = 0
                if sps.num_short_term_rps > 1:
                    import math
                    ridx = br.read_bits(
                        math.ceil(math.log2(sps.num_short_term_rps)))
                if ridx < len(sps.short_term_rps):
                    h.rps = sps.short_term_rps[ridx]
            if sps.long_term_ref_pics_present:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec, "long-term reference pics")
            if sps.temporal_mvp_enabled:
                h.temporal_mvp = br.read_flag()
        if sps.sample_adaptive_offset_enabled:
            h.sao_luma = br.read_flag()
            h.sao_chroma = br.read_flag()
        if h.slice_type != 2:          # P/B slice inter fields (spec 7.3.6.1)
            is_b = h.slice_type == 0
            if br.read_flag():         # num_ref_idx_active_override
                h.num_ref_idx_l0 = br.read_ue() + 1
                if is_b:
                    h.num_ref_idx_l1 = br.read_ue() + 1
            else:
                h.num_ref_idx_l0 = pps.num_ref_idx_l0_default
                h.num_ref_idx_l1 = pps.num_ref_idx_l1_default
            n_total_curr = 0
            if h.rps is not None:
                n_total_curr = sum(bool(u) for u in h.rps.used_s0) + \
                    sum(bool(u) for u in h.rps.used_s1)
            if pps.lists_modification_present and n_total_curr > 1:
                import math
                bits = math.ceil(math.log2(n_total_curr))
                if br.read_flag():     # ref_pic_list_modification_flag_l0
                    h.rplm_l0 = [br.read_bits(bits)
                                 for _ in range(h.num_ref_idx_l0)]
                if is_b and br.read_flag():  # ..._flag_l1
                    h.rplm_l1 = [br.read_bits(bits)
                                 for _ in range(h.num_ref_idx_l1)]
            if is_b:
                h.mvd_l1_zero = br.read_flag()
            if pps.cabac_init_present:
                h.cabac_init_flag = br.read_flag()
            if h.temporal_mvp:
                # collocated picture selection (spec 7.3.6.1)
                if is_b:
                    h.collocated_from_l0 = br.read_flag()
                if (h.collocated_from_l0 and h.num_ref_idx_l0 > 1) or \
                        (not h.collocated_from_l0 and
                         h.num_ref_idx_l1 > 1):
                    h.collocated_ref_idx = br.read_ue()
            if pps.weighted_pred and not is_b:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec, "weighted prediction")
            if pps.weighted_bipred and is_b:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec, "weighted bi-prediction")
            h.max_num_merge_cand = 5 - br.read_ue()
        h.qp = pps.init_qp + br.read_se()
        if pps.slice_chroma_qp_offsets_present:
            h.cb_qp_offset = br.read_se()
            h.cr_qp_offset = br.read_se()
        dbf_override = False
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                dbf_override = br.read_flag()
            if dbf_override:
                h.deblocking_filter_disabled = br.read_flag()
                if not h.deblocking_filter_disabled:
                    h.beta_offset_div2 = br.read_se()
                    h.tc_offset_div2 = br.read_se()
            else:
                h.deblocking_filter_disabled = pps.deblocking_filter_disabled
                h.beta_offset_div2 = pps.beta_offset_div2
                h.tc_offset_div2 = pps.tc_offset_div2
        else:
            h.deblocking_filter_disabled = pps.deblocking_filter_disabled
            h.beta_offset_div2 = pps.beta_offset_div2
            h.tc_offset_div2 = pps.tc_offset_div2
        if pps.loop_filter_across_slices and (h.sao_luma or h.sao_chroma or
                                              not h.deblocking_filter_disabled):
            h.loop_filter_across_slices = br.read_flag()
        else:
            h.loop_filter_across_slices = pps.loop_filter_across_slices
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        h.num_entry_points = br.read_ue()
        if h.num_entry_points:
            offset_len = br.read_ue() + 1
            h.entry_point_offsets = [br.read_bits(offset_len) + 1
                                     for _ in range(h.num_entry_points)]
    if pps.slice_segment_header_extension_present:
        ext_len = br.read_ue()
        br.skip_bits(8 * ext_len)
    # byte_alignment(): alignment bit '1' then zeros
    one = br.read_bits(1)
    if one != 1:
        raise HeifError.invalid_input(msg="missing slice header alignment bit")
    br.byte_align()
    h.data_offset_bits = (len(rbsp) * 8 - br.bits_remaining())
    return h
