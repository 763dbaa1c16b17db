"""AV1 OBU and uncompressed-header parsing (AV1 spec §5).

Host-side, like the reference's hvcC/SPS path (ref: libheif/codecs/
avif_boxes.cc parses the sequence-header OBU for av1C). This module
parses the full intra/still-picture header set: sequence header, frame
header, tile group framing. Inter-frame syntax is rejected — HEIF/AVIF
stills are key frames.

Counterpart of libheif_tpu/codecs/av1/obu.py, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ...core.error import HeifError, SubError

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_PADDING = 15


class BitReader:
    """MSB-first bit reader over bytes (spec f(n) / uvlc / le / leb128)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0          # bit position

    def f(self, n: int) -> int:
        if self.pos + n > len(self.data) * 8:
            raise HeifError.eof("AV1 OBU bitstream truncated")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        leading = 0
        while self.f(1) == 0:
            leading += 1
            if leading > 32:
                raise HeifError.invalid_input(msg="uvlc overflow")
        if leading >= 32:
            return (1 << 32) - 1
        return (1 << leading) - 1 + (self.f(leading) if leading else 0)

    def su(self, n: int) -> int:
        """signed: n magnitude bits + sign handling per spec su(1+n)."""
        v = self.f(n)
        sign_mask = 1 << (n - 1)
        if v & sign_mask:
            v = v - 2 * sign_mask
        return v

    def ns(self, n: int) -> int:
        """non-symmetric unsigned (spec ns(n))."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        extra = self.f(1)
        return (v << 1) - m + extra

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def delta_q(self) -> int:
        if self.f(1):
            return self.su(7)
        return 0


def read_leb128(data: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    for i in range(8):
        b = data[pos + i]
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return v, pos + i + 1
    raise HeifError.invalid_input(msg="leb128 overflow")


@dataclass
class OBU:
    type: int
    payload: bytes
    temporal_id: int = 0
    spatial_id: int = 0


def split_obus(data: bytes) -> List[OBU]:
    """Split a temporal unit / av1C payload into OBUs (spec §5.2)."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        hdr = data[pos]
        if hdr & 0x80:
            raise HeifError.invalid_input(msg="obu_forbidden_bit set")
        obu_type = (hdr >> 3) & 0xF
        ext_flag = (hdr >> 2) & 1
        has_size = (hdr >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext_flag:
            ext = data[pos]
            tid, sid = ext >> 5, (ext >> 3) & 3
            pos += 1
        if has_size:
            size, pos = read_leb128(data, pos)
        else:
            size = n - pos
        if pos + size > n:
            raise HeifError.invalid_input(msg="OBU overruns buffer")
        out.append(OBU(obu_type, data[pos:pos + size], tid, sid))
        pos += size
    return out


# ---------------------------------------------------------------- sequence

@dataclass
class SequenceHeader:
    seq_profile: int = 0
    still_picture: bool = False
    reduced_still_picture: bool = False
    timing_info_present: bool = False
    decoder_model_info_present: bool = False
    operating_points: int = 1
    seq_level_idx: List[int] = field(default_factory=lambda: [0])
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = False
    order_hint_bits: int = 0
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    seq_force_screen_content_tools: int = 2
    seq_force_integer_mv: int = 2
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    # color config
    bit_depth: int = 8
    monochrome: bool = False
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: bool = False
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    """(spec §5.5)."""
    r = BitReader(payload)
    s = SequenceHeader()
    s.seq_profile = r.f(3)
    s.still_picture = bool(r.f(1))
    s.reduced_still_picture = bool(r.f(1))
    if s.reduced_still_picture:
        s.seq_level_idx = [r.f(5)]
    else:
        s.timing_info_present = bool(r.f(1))
        if s.timing_info_present:
            # timing_info()
            r.f(32)  # num_units_in_display_tick
            r.f(32)  # time_scale
            if r.f(1):  # equal_picture_interval
                r.uvlc()
            s.decoder_model_info_present = bool(r.f(1))
            if s.decoder_model_info_present:
                r.f(5)   # buffer_delay_length_minus_1
                r.f(32)  # num_units_in_decoding_tick
                r.f(5)   # buffer_removal_time_length
                r.f(5)   # frame_presentation_time_length
        initial_display_delay_present = bool(r.f(1))
        n_ops = r.f(5) + 1
        s.operating_points = n_ops
        s.seq_level_idx = []
        for _ in range(n_ops):
            r.f(12)  # operating_point_idc
            lvl = r.f(5)
            s.seq_level_idx.append(lvl)
            if lvl > 7:
                r.f(1)  # seq_tier
            if s.decoder_model_info_present:
                if r.f(1):  # decoder_model_present_for_op
                    raise HeifError.unsupported(
                        SubError.Unsupported_codec,
                        "decoder model operating parameters")
            if initial_display_delay_present:
                if r.f(1):
                    r.f(4)
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.max_frame_width = r.f(s.frame_width_bits) + 1
    s.max_frame_height = r.f(s.frame_height_bits) + 1
    if not s.reduced_still_picture:
        s.frame_id_numbers_present = bool(r.f(1))
        if s.frame_id_numbers_present:
            s.delta_frame_id_length = r.f(4) + 2
            s.additional_frame_id_length = r.f(3) + 1
    s.use_128x128_superblock = bool(r.f(1))
    s.enable_filter_intra = bool(r.f(1))
    s.enable_intra_edge_filter = bool(r.f(1))
    if not s.reduced_still_picture:
        s.enable_interintra_compound = bool(r.f(1))
        s.enable_masked_compound = bool(r.f(1))
        s.enable_warped_motion = bool(r.f(1))
        s.enable_dual_filter = bool(r.f(1))
        s.enable_order_hint = bool(r.f(1))
        if s.enable_order_hint:
            s.enable_jnt_comp = bool(r.f(1))
            s.enable_ref_frame_mvs = bool(r.f(1))
        s.seq_force_screen_content_tools = 2 if r.f(1) else r.f(1)
        if s.seq_force_screen_content_tools > 0:
            s.seq_force_integer_mv = 2 if r.f(1) else r.f(1)
        if s.enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    else:
        s.seq_force_screen_content_tools = 2
        s.seq_force_integer_mv = 2
    s.enable_superres = bool(r.f(1))
    s.enable_cdef = bool(r.f(1))
    s.enable_restoration = bool(r.f(1))
    # color_config (spec §5.5.2)
    high_bitdepth = r.f(1)
    if s.seq_profile == 2 and high_bitdepth:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high_bitdepth else 8
    if s.seq_profile != 1:
        s.monochrome = bool(r.f(1))
    if r.f(1):  # color_description_present
        s.color_primaries = r.f(8)
        s.transfer_characteristics = r.f(8)
        s.matrix_coefficients = r.f(8)
    if s.monochrome:
        s.color_range = bool(r.f(1))
        s.subsampling_x = s.subsampling_y = 1
    elif (s.color_primaries == 1 and s.transfer_characteristics == 13
          and s.matrix_coefficients == 0):
        s.color_range = True
        s.subsampling_x = s.subsampling_y = 0
    else:
        s.color_range = bool(r.f(1))
        if s.seq_profile == 0:
            s.subsampling_x = s.subsampling_y = 1
        elif s.seq_profile == 1:
            s.subsampling_x = s.subsampling_y = 0
        else:
            if s.bit_depth == 12:
                s.subsampling_x = r.f(1)
                s.subsampling_y = r.f(1) if s.subsampling_x else 0
            else:
                s.subsampling_x, s.subsampling_y = 1, 0
        if s.subsampling_x and s.subsampling_y:
            s.chroma_sample_position = r.f(2)
    if not s.monochrome:
        s.separate_uv_delta_q = bool(r.f(1))
    s.film_grain_params_present = bool(r.f(1))
    return s


# ------------------------------------------------------------------- frame

@dataclass
class TileInfo:
    uniform_spacing: bool = True
    cols_log2: int = 0
    rows_log2: int = 0
    cols: int = 1
    rows: int = 1
    col_starts: List[int] = field(default_factory=list)   # in superblocks
    row_starts: List[int] = field(default_factory=list)
    context_update_id: int = 0
    size_bytes: int = 4


@dataclass
class Quantization:
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0


@dataclass
class Segmentation:
    enabled: bool = False


@dataclass
class CdefParams:
    damping: int = 3
    bits: int = 0
    y_pri: List[int] = field(default_factory=lambda: [0])
    y_sec: List[int] = field(default_factory=lambda: [0])
    uv_pri: List[int] = field(default_factory=lambda: [0])
    uv_sec: List[int] = field(default_factory=lambda: [0])


@dataclass
class FrameHeader:
    frame_type: int = 0          # 0 = KEY
    show_frame: bool = True
    frame_width: int = 0
    frame_height: int = 0
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = 8
    upscaled_width: int = 0
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    allow_intrabc: bool = False
    tile_info: TileInfo = field(default_factory=TileInfo)
    quant: Quantization = field(default_factory=Quantization)
    seg: Segmentation = field(default_factory=Segmentation)
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    coded_lossless: bool = False
    all_lossless: bool = False
    loop_filter_levels: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    loop_filter_sharpness: int = 0
    loop_filter_delta_enabled: bool = False
    loop_filter_ref_deltas: List[int] = field(
        default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    loop_filter_mode_deltas: List[int] = field(default_factory=lambda: [0, 0])
    cdef: CdefParams = field(default_factory=CdefParams)
    lr_type: Tuple[int, int, int] = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 0
    lr_unit_size: Tuple[int, int, int] = (64, 64, 64)
    tx_mode_select: bool = False
    reduced_tx_set: bool = False
    film_grain: Optional["FilmGrainParams"] = None
    header_bit_size: int = 0     # bits consumed (for OBU_FRAME)


@dataclass
class FilmGrainParams:
    """film_grain_params (spec 5.9.30); applied by grain.py 7.18.3."""
    grain_seed: int = 0
    num_y_points: int = 0
    point_y: List[Tuple[int, int]] = field(default_factory=list)
    chroma_scaling_from_luma: bool = False
    num_cb_points: int = 0
    point_cb: List[Tuple[int, int]] = field(default_factory=list)
    num_cr_points: int = 0
    point_cr: List[Tuple[int, int]] = field(default_factory=list)
    grain_scaling: int = 8       # grain_scaling_minus_8 + 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: List[int] = field(default_factory=list)     # signed
    ar_coeffs_cb: List[int] = field(default_factory=list)
    ar_coeffs_cr: List[int] = field(default_factory=list)
    ar_coeff_shift: int = 6      # ar_coeff_shift_minus_6 + 6
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0           # signed (parse value - 256)
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


def parse_film_grain_params(r, seq, fh) -> Optional[FilmGrainParams]:
    """(spec 5.9.30) — called with apply_grain already read as 1."""
    g = FilmGrainParams()
    g.grain_seed = r.f(16)
    if fh.frame_type == 1:               # INTER: update_grain flag
        if not r.f(1):
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "film grain params referencing a previous frame")
    g.num_y_points = r.f(4)
    for _ in range(g.num_y_points):
        v = r.f(8)
        s = r.f(8)
        g.point_y.append((v, s))
    if seq.monochrome:
        g.chroma_scaling_from_luma = False
    else:
        g.chroma_scaling_from_luma = bool(r.f(1))
    if seq.monochrome or g.chroma_scaling_from_luma or \
            (seq.subsampling_x == 1 and seq.subsampling_y == 1 and
             g.num_y_points == 0):
        g.num_cb_points = 0
        g.num_cr_points = 0
    else:
        g.num_cb_points = r.f(4)
        for _ in range(g.num_cb_points):
            v = r.f(8)
            s = r.f(8)
            g.point_cb.append((v, s))
        g.num_cr_points = r.f(4)
        for _ in range(g.num_cr_points):
            v = r.f(8)
            s = r.f(8)
            g.point_cr.append((v, s))
    g.grain_scaling = r.f(2) + 8
    g.ar_coeff_lag = r.f(2)
    num_pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    if g.num_y_points:
        num_pos_chroma = num_pos_luma + 1
        g.ar_coeffs_y = [r.f(8) - 128 for _ in range(num_pos_luma)]
    else:
        num_pos_chroma = num_pos_luma
    if g.chroma_scaling_from_luma or g.num_cb_points:
        g.ar_coeffs_cb = [r.f(8) - 128 for _ in range(num_pos_chroma)]
    if g.chroma_scaling_from_luma or g.num_cr_points:
        g.ar_coeffs_cr = [r.f(8) - 128 for _ in range(num_pos_chroma)]
    g.ar_coeff_shift = r.f(2) + 6
    g.grain_scale_shift = r.f(2)
    if g.num_cb_points:
        g.cb_mult = r.f(8) - 128       # biased signed (spec 7.18.3.5)
        g.cb_luma_mult = r.f(8) - 128
        g.cb_offset = r.f(9) - 256
    if g.num_cr_points:
        g.cr_mult = r.f(8) - 128
        g.cr_luma_mult = r.f(8) - 128
        g.cr_offset = r.f(9) - 256
    g.overlap_flag = bool(r.f(1))
    g.clip_to_restricted_range = bool(r.f(1))
    return g


def _mi_size(v: int) -> int:
    return (v + 7) >> 3 << 1     # 4x4 units, rounded to 8px


def parse_frame_header(payload: bytes, seq: SequenceHeader) -> FrameHeader:
    """Intra/still frame header (spec §5.9). Inter features rejected."""
    r = BitReader(payload)
    fh = FrameHeader()
    if seq.reduced_still_picture:
        fh.frame_type = 0
        fh.show_frame = True
        show_existing = False
        error_resilient = False
    else:
        show_existing = bool(r.f(1))
        if show_existing:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "show_existing_frame")
        fh.frame_type = r.f(2)
        fh.show_frame = bool(r.f(1))
        if not fh.show_frame:
            r.f(1)  # showable_frame
        if fh.frame_type == 3 or (fh.frame_type == 0 and fh.show_frame):
            error_resilient = fh.frame_type == 3
        else:
            error_resilient = bool(r.f(1))
    if fh.frame_type not in (0, 2):
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "inter frames in image item")
    fh.disable_cdf_update = bool(r.f(1))
    if seq.seq_force_screen_content_tools == 2:
        fh.allow_screen_content_tools = bool(r.f(1))
    else:
        fh.allow_screen_content_tools = bool(
            seq.seq_force_screen_content_tools)
    if fh.allow_screen_content_tools and seq.seq_force_integer_mv == 2:
        r.f(1)  # force_integer_mv (intra frames: implied 1)
    if seq.frame_id_numbers_present:
        r.f(seq.delta_frame_id_length + seq.additional_frame_id_length)
    if fh.frame_type == 3:
        frame_size_override = True
    elif seq.reduced_still_picture:
        frame_size_override = False
    else:
        frame_size_override = bool(r.f(1))
    if not seq.reduced_still_picture:
        if seq.enable_order_hint:
            r.f(seq.order_hint_bits)  # order_hint
        # primary_ref_frame: intra frames → PRIMARY_REF_NONE implied only
        # when error resilient; otherwise coded
        if not error_resilient and fh.frame_type not in (0, 2):
            r.f(3)
    if seq.decoder_model_info_present:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "decoder model present")
    if not seq.reduced_still_picture:
        if fh.frame_type in (0, 2) and fh.show_frame:
            # refresh_frame_flags implied 0xFF for shown key frame
            if fh.frame_type == 2:
                r.f(8)
        else:
            r.f(8)
    # frame_size()
    if frame_size_override:
        fh.frame_width = r.f(seq.frame_width_bits) + 1
        fh.frame_height = r.f(seq.frame_height_bits) + 1
    else:
        fh.frame_width = seq.max_frame_width
        fh.frame_height = seq.max_frame_height
    # superres_params()
    fh.upscaled_width = fh.frame_width
    if seq.enable_superres and r.f(1):
        fh.superres_denom = r.f(3) + 9
        fh.frame_width = (fh.upscaled_width * 8 +
                          (fh.superres_denom // 2)) // fh.superres_denom
        raise HeifError.unsupported(SubError.Unsupported_codec, "superres")
    # render_size()
    if r.f(1):
        fh.render_width = r.f(16) + 1
        fh.render_height = r.f(16) + 1
    else:
        fh.render_width = fh.upscaled_width
        fh.render_height = fh.frame_height
    if fh.allow_screen_content_tools and fh.upscaled_width == fh.frame_width:
        fh.allow_intrabc = bool(r.f(1))
    # read_tile_info (spec §5.9.15)
    _parse_tile_info(r, fh, seq)
    # quantization_params (spec §5.9.12)
    q = fh.quant
    q.base_q_idx = r.f(8)
    q.delta_q_y_dc = r.delta_q()
    if not seq.monochrome:
        if seq.separate_uv_delta_q:
            diff_uv_delta = bool(r.f(1))
        else:
            diff_uv_delta = False
        q.delta_q_u_dc = r.delta_q()
        q.delta_q_u_ac = r.delta_q()
        if diff_uv_delta:
            q.delta_q_v_dc = r.delta_q()
            q.delta_q_v_ac = r.delta_q()
        else:
            q.delta_q_v_dc = q.delta_q_u_dc
            q.delta_q_v_ac = q.delta_q_u_ac
    q.using_qmatrix = bool(r.f(1))
    if q.using_qmatrix:
        q.qm_y = r.f(4)
        q.qm_u = r.f(4)
        if seq.separate_uv_delta_q:
            q.qm_v = r.f(4)
        else:
            q.qm_v = q.qm_u
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "quantizer matrices")
    # segmentation_params (spec §5.9.14)
    fh.seg.enabled = bool(r.f(1))
    if fh.seg.enabled:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "segmentation")
    # delta_q_params
    if q.base_q_idx > 0:
        fh.delta_q_present = bool(r.f(1))
    if fh.delta_q_present:
        fh.delta_q_res = r.f(2)
    # delta_lf_params
    if fh.delta_q_present:
        if not fh.allow_intrabc:
            fh.delta_lf_present = bool(r.f(1))
        if fh.delta_lf_present:
            fh.delta_lf_res = r.f(2)
            fh.delta_lf_multi = bool(r.f(1))
    # CodedLossless
    lossless = (q.base_q_idx == 0 and q.delta_q_y_dc == 0 and
                q.delta_q_u_ac == 0 and q.delta_q_u_dc == 0 and
                q.delta_q_v_ac == 0 and q.delta_q_v_dc == 0)
    fh.coded_lossless = lossless
    fh.all_lossless = lossless and fh.frame_width == fh.upscaled_width
    # loop_filter_params (spec §5.9.11)
    if not fh.coded_lossless and not fh.allow_intrabc:
        fh.loop_filter_levels[0] = r.f(6)
        fh.loop_filter_levels[1] = r.f(6)
        if not seq.monochrome:
            if fh.loop_filter_levels[0] or fh.loop_filter_levels[1]:
                fh.loop_filter_levels[2] = r.f(6)
                fh.loop_filter_levels[3] = r.f(6)
        fh.loop_filter_sharpness = r.f(3)
        fh.loop_filter_delta_enabled = bool(r.f(1))
        if fh.loop_filter_delta_enabled:
            if r.f(1):  # loop_filter_delta_update
                for i in range(8):
                    if r.f(1):
                        fh.loop_filter_ref_deltas[i] = r.su(7)
                for i in range(2):
                    if r.f(1):
                        fh.loop_filter_mode_deltas[i] = r.su(7)
    # cdef_params (spec §5.9.19)
    if not fh.coded_lossless and not fh.allow_intrabc and seq.enable_cdef:
        c = fh.cdef
        c.damping = r.f(2) + 3
        c.bits = r.f(2)
        n = 1 << c.bits
        c.y_pri, c.y_sec, c.uv_pri, c.uv_sec = [], [], [], []
        # strengths interleave y/uv per index (spec 5.9.19);
        # sec strength 3 means 4
        for _ in range(n):
            c.y_pri.append(r.f(4))
            s = r.f(2)
            c.y_sec.append(4 if s == 3 else s)
            if not seq.monochrome:
                c.uv_pri.append(r.f(4))
                s = r.f(2)
                c.uv_sec.append(4 if s == 3 else s)
    # lr_params (spec §5.9.20)
    if (not fh.all_lossless and not fh.allow_intrabc
            and seq.enable_restoration):
        kinds = []
        uses = False
        n_planes = 1 if seq.monochrome else 3
        for _ in range(n_planes):
            k = r.f(2)
            kinds.append(k)
            uses = uses or k != 0
        # raw 2-bit codes are already in FrameRestorationType order:
        # 0 none, 1 switchable, 2 wiener, 3 sgrproj (spec Remap_Lr_Type)
        fh.lr_type = tuple(kinds + [0] * (3 - len(kinds)))
        if uses:
            if seq.use_128x128_superblock:
                fh.lr_unit_shift = r.f(1) + 1
            else:
                fh.lr_unit_shift = r.f(1)
                if fh.lr_unit_shift:
                    fh.lr_unit_shift += r.f(1)
            # spec 5.9.20: the uv shift bit is present only when a
            # CHROMA plane uses restoration (usesChromaLr) — reading it
            # for luma-only LR shifted the whole header by one bit
            uses_chroma_lr = any(k != 0 for k in kinds[1:])
            if seq.subsampling_x and seq.subsampling_y and uses_chroma_lr:
                fh.lr_uv_shift = r.f(1)
        # luma unit size: 256 >> (2 - shift)  (spec 5.9.20,
        # RESTORATION_TILESIZE_MAX = 256); chroma >> lr_uv_shift
        fh.lr_unit_size = (256 >> (2 - fh.lr_unit_shift),)
        fh.lr_unit_size = (fh.lr_unit_size[0],
                           fh.lr_unit_size[0] >> fh.lr_uv_shift,
                           fh.lr_unit_size[0] >> fh.lr_uv_shift)
    # read_tx_mode
    if fh.coded_lossless:
        fh.tx_mode_select = False
    else:
        fh.tx_mode_select = bool(r.f(1))
    # frame_reference_mode: intra frame → nothing
    # skip_mode_params: intra → nothing
    # allow_warped_motion: intra → not coded
    fh.reduced_tx_set = bool(r.f(1))
    # global_motion_params: intra → nothing
    # film_grain_params
    if seq.film_grain_params_present and fh.show_frame:
        if r.f(1):          # apply_grain
            fh.film_grain = parse_film_grain_params(r, seq, fh)
    fh.header_bit_size = r.pos
    return fh


def _parse_tile_info(r: BitReader, fh: FrameHeader,
                     seq: SequenceHeader) -> None:
    ti = fh.tile_info
    sb_shift = 5 if seq.use_128x128_superblock else 4   # log2 in px... mi
    sb_size_log2 = sb_shift + 2
    mi_cols = _mi_size(fh.frame_width)
    mi_rows = _mi_size(fh.frame_height)
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    # spec 5.9.15 limits
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    ti.uniform_spacing = bool(r.f(1))
    if ti.uniform_spacing:
        ti.cols_log2 = min_log2_tile_cols
        while ti.cols_log2 < max_log2_tile_cols and r.f(1):
            ti.cols_log2 += 1
        tile_width_sb = (sb_cols + (1 << ti.cols_log2) - 1) >> ti.cols_log2
        ti.col_starts = list(range(0, sb_cols, tile_width_sb)) + [sb_cols]
        ti.cols = len(ti.col_starts) - 1
        min_log2_tile_rows = max(min_log2_tiles - ti.cols_log2, 0)
        ti.rows_log2 = min_log2_tile_rows
        while ti.rows_log2 < max_log2_tile_rows and r.f(1):
            ti.rows_log2 += 1
        tile_height_sb = (sb_rows + (1 << ti.rows_log2) - 1) >> ti.rows_log2
        ti.row_starts = list(range(0, sb_rows, tile_height_sb)) + [sb_rows]
        ti.rows = len(ti.row_starts) - 1
    else:
        ti.col_starts = [0]
        widest = 0
        start_sb = 0
        while start_sb < sb_cols:
            max_w = min(sb_cols - start_sb, max_tile_width_sb)
            w = r.ns(max_w) + 1
            widest = max(widest, w)
            start_sb += w
            ti.col_starts.append(start_sb)
        ti.cols = len(ti.col_starts) - 1
        ti.cols_log2 = _tile_log2(1, ti.cols)
        if min_log2_tiles > 0:
            max_tile_area_sb_var = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            max_tile_area_sb_var = sb_rows * sb_cols
        max_tile_height_sb = max(max_tile_area_sb_var // widest, 1)
        ti.row_starts = [0]
        start_sb = 0
        while start_sb < sb_rows:
            max_h = min(sb_rows - start_sb, max_tile_height_sb)
            h = r.ns(max_h) + 1
            start_sb += h
            ti.row_starts.append(start_sb)
        ti.rows = len(ti.row_starts) - 1
        ti.rows_log2 = _tile_log2(1, ti.rows)
    if ti.cols_log2 > 0 or ti.rows_log2 > 0:
        ti.context_update_id = r.f(ti.cols_log2 + ti.rows_log2)
        ti.size_bytes = r.f(2) + 1


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


@dataclass
class TileGroup:
    tile_start: int
    tile_end: int
    tile_data: List[bytes]      # per-tile coded payloads


def parse_tile_group(payload: bytes, ti: TileInfo,
                     start_bit: int = 0) -> TileGroup:
    """(spec §5.11.1): tile_start_and_end + per-tile sizes."""
    r = BitReader(payload)
    r.pos = start_bit
    num_tiles = ti.cols * ti.rows
    if num_tiles > 1:
        tile_start_and_end_present = bool(r.f(1))
    else:
        tile_start_and_end_present = False
    if not tile_start_and_end_present:
        tg_start, tg_end = 0, num_tiles - 1
    else:
        bits = ti.cols_log2 + ti.rows_log2
        tg_start = r.f(bits)
        tg_end = r.f(bits)
    r.byte_align()
    pos = r.pos >> 3
    tiles = []
    for t in range(tg_start, tg_end + 1):
        if t == tg_end:
            tiles.append(payload[pos:])
        else:
            sz = int.from_bytes(payload[pos:pos + ti.size_bytes],
                                "little") + 1
            pos += ti.size_bytes
            tiles.append(payload[pos:pos + sz])
            pos += sz
    return TileGroup(tg_start, tg_end, tiles)
