"""The HEVC, AV1, JPEG, AVC and VVC codec configuration boxes (hvcC,
av1C, jpgC, avcC, vvcC), NAL emulation prevention, and the head of an
HEVC SPS that fills an encoder's hvcC (``parse_hevc_sps``,
``hvcC_from_sps``).

Counterpart of libheif_tpu/boxes/codec_cfg.py (reference:
libheif/codecs/hevc_boxes.{h,cc} Box_hvcC hevc_boxes.h:35,
avif_boxes.cc:36 Box_av1C, jpeg_boxes.h:32 Box_jpgC, avc_boxes.h:34
Box_avcC, vvc_boxes.h:32 Box_vvcC).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..core.bitstream import BitReader, ByteReader, ByteWriter
from ..core.error import HeifError, SubError
from ..core.limits import SecurityLimits
from .box import Box, FullBox, register_box


@dataclass
class HvcCNalArray:
    array_completeness: bool = True
    nal_unit_type: int = 0
    nal_units: List[bytes] = field(default_factory=list)


@register_box("hvcC")
class Box_hvcC(Box):
    """HEVCDecoderConfigurationRecord (ISO/IEC 14496-15 §8.3.3.1; ref:
    hevc_boxes.h:35 Box_hvcC)."""

    NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34

    def __init__(self):
        super().__init__()
        self.configuration_version = 1
        self.general_profile_space = 0
        self.general_tier_flag = 0
        self.general_profile_idc = 0
        self.general_profile_compatibility_flags = 0
        self.general_constraint_indicator_flags = 0
        self.general_level_idc = 0
        self.min_spatial_segmentation_idc = 0
        self.parallelism_type = 0
        self.chroma_format = 1
        self.bit_depth_luma = 8
        self.bit_depth_chroma = 8
        self.avg_frame_rate = 0
        self.constant_frame_rate = 0
        self.num_temporal_layers = 1
        self.temporal_id_nested = 1
        self.length_size = 4  # NAL length prefix size in bytes
        self.nal_arrays: List[HvcCNalArray] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.configuration_version = r.read8()
        b = r.read8()
        self.general_profile_space = b >> 6
        self.general_tier_flag = (b >> 5) & 1
        self.general_profile_idc = b & 0x1F
        self.general_profile_compatibility_flags = r.read32()
        self.general_constraint_indicator_flags = \
            (r.read32() << 16) | r.read16()
        self.general_level_idc = r.read8()
        self.min_spatial_segmentation_idc = r.read16() & 0x0FFF
        self.parallelism_type = r.read8() & 0x3
        self.chroma_format = r.read8() & 0x3
        self.bit_depth_luma = (r.read8() & 0x7) + 8
        self.bit_depth_chroma = (r.read8() & 0x7) + 8
        self.avg_frame_rate = r.read16()
        b = r.read8()
        self.constant_frame_rate = b >> 6
        self.num_temporal_layers = (b >> 3) & 0x7
        self.temporal_id_nested = (b >> 2) & 1
        self.length_size = (b & 0x3) + 1
        num_arrays = r.read8()
        self.nal_arrays = []
        for _ in range(num_arrays):
            b = r.read8()
            arr = HvcCNalArray(bool(b & 0x80), b & 0x3F)
            n = r.read16()
            for _ in range(n):
                ln = r.read16()
                arr.nal_units.append(r.read_bytes(ln))
            self.nal_arrays.append(arr)

    def write_payload(self, w: ByteWriter) -> None:
        w.write8(self.configuration_version)
        w.write8((self.general_profile_space << 6) |
                 (self.general_tier_flag << 5) | self.general_profile_idc)
        w.write32(self.general_profile_compatibility_flags)
        w.write32(self.general_constraint_indicator_flags >> 16)
        w.write16(self.general_constraint_indicator_flags & 0xFFFF)
        w.write8(self.general_level_idc)
        w.write16(0xF000 | self.min_spatial_segmentation_idc)
        w.write8(0xFC | self.parallelism_type)
        w.write8(0xFC | self.chroma_format)
        w.write8(0xF8 | (self.bit_depth_luma - 8))
        w.write8(0xF8 | (self.bit_depth_chroma - 8))
        w.write16(self.avg_frame_rate)
        w.write8((self.constant_frame_rate << 6) |
                 (self.num_temporal_layers << 3) |
                 (self.temporal_id_nested << 2) | (self.length_size - 1))
        w.write8(len(self.nal_arrays))
        for arr in self.nal_arrays:
            w.write8((0x80 if arr.array_completeness else 0)
                     | arr.nal_unit_type)
            w.write16(len(arr.nal_units))
            for nal in arr.nal_units:
                w.write16(len(nal))
                w.write_bytes(nal)

    def get_header_nals(self) -> List[bytes]:
        """All VPS/SPS/PPS NALs in array order, as stored."""
        return [nal for arr in self.nal_arrays for nal in arr.nal_units]

    def add_nal(self, nal: bytes) -> None:
        nal_type = (nal[0] >> 1) & 0x3F
        for arr in self.nal_arrays:
            if arr.nal_unit_type == nal_type:
                arr.nal_units.append(nal)
                return
        self.nal_arrays.append(HvcCNalArray(True, nal_type, [nal]))

    def dump_fields(self) -> List[str]:
        return [
            f"profile: space={self.general_profile_space} "
            f"idc={self.general_profile_idc} "
            f"level={self.general_level_idc / 30:.1f}",
            f"chroma format: {self.chroma_format}, bit depth: "
            f"{self.bit_depth_luma}/{self.bit_depth_chroma}",
            "NAL arrays: " + " ".join(
                f"type{a.nal_unit_type}x{len(a.nal_units)}"
                for a in self.nal_arrays),
        ]


@register_box("av1C")
class Box_av1C(Box):
    """AV1 codec configuration (ref: avif_boxes.cc:36 Box_av1C::parse)."""

    def __init__(self):
        super().__init__()
        self.seq_profile = 0
        self.seq_level_idx_0 = 0
        self.seq_tier_0 = 0
        self.high_bitdepth = 0
        self.twelve_bit = 0
        self.monochrome = 0
        self.chroma_subsampling_x = 1
        self.chroma_subsampling_y = 1
        self.chroma_sample_position = 0
        self.initial_presentation_delay_present = 0
        self.initial_presentation_delay_minus_one = 0
        self.config_obus = b""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        b = r.read8()
        marker, version = b >> 7, b & 0x7F
        if marker != 1 or version != 1:
            raise HeifError.invalid_input(
                SubError.Invalid_parameter_value, "invalid av1C marker/version")
        b = r.read8()
        self.seq_profile = b >> 5
        self.seq_level_idx_0 = b & 0x1F
        b = r.read8()
        self.seq_tier_0 = b >> 7
        self.high_bitdepth = (b >> 6) & 1
        self.twelve_bit = (b >> 5) & 1
        self.monochrome = (b >> 4) & 1
        self.chroma_subsampling_x = (b >> 3) & 1
        self.chroma_subsampling_y = (b >> 2) & 1
        self.chroma_sample_position = b & 0x3
        b = r.read8()
        self.initial_presentation_delay_present = (b >> 4) & 1
        self.initial_presentation_delay_minus_one = b & 0xF
        self.config_obus = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        w.write8(0x81)
        w.write8((self.seq_profile << 5) | self.seq_level_idx_0)
        w.write8((self.seq_tier_0 << 7) | (self.high_bitdepth << 6) |
                 (self.twelve_bit << 5) | (self.monochrome << 4) |
                 (self.chroma_subsampling_x << 3) |
                 (self.chroma_subsampling_y << 2) | self.chroma_sample_position)
        w.write8((self.initial_presentation_delay_present << 4) |
                 (self.initial_presentation_delay_minus_one
                  if self.initial_presentation_delay_present else 0))
        w.write_bytes(self.config_obus)

    @property
    def bit_depth(self) -> int:
        if self.high_bitdepth:
            return 12 if self.twelve_bit else 10
        return 8

    def dump_fields(self) -> List[str]:
        return [f"seq_profile: {self.seq_profile}, level: {self.seq_level_idx_0}",
                f"bitdepth: {self.bit_depth}, monochrome: {self.monochrome}, "
                f"subsampling: {self.chroma_subsampling_x}{self.chroma_subsampling_y}",
                f"configOBUs: {len(self.config_obus)} bytes"]


@register_box("jpgC")
class Box_jpgC(Box):
    """JPEG configuration: stream bytes that go in front of the item data,
    typically SOI and the tables (ref: jpeg_boxes.h:32)."""

    def __init__(self, data: bytes = b""):
        super().__init__()
        self.data = data

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.data = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.data)


@register_box("avcC")
class Box_avcC(Box):
    """AVC decoder configuration, ISO/IEC 14496-15 §5.3.3.1 (ref:
    avc_boxes.h:34 Box_avcC).  The high-profile extension bytes after the
    PPS list pass through as ``trailing``."""

    def __init__(self):
        super().__init__()
        self.configuration_version = 1
        self.avc_profile = 0
        self.profile_compatibility = 0
        self.avc_level = 0
        self.length_size = 4
        self.sps_list: List[bytes] = []
        self.pps_list: List[bytes] = []
        self.trailing = b""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth=0) -> None:
        self.configuration_version = r.read8()
        self.avc_profile = r.read8()
        self.profile_compatibility = r.read8()
        self.avc_level = r.read8()
        self.length_size = (r.read8() & 0x3) + 1
        n_sps = r.read8() & 0x1F
        for _ in range(n_sps):
            self.sps_list.append(r.read_bytes(r.read16()))
        n_pps = r.read8()
        for _ in range(n_pps):
            self.pps_list.append(r.read_bytes(r.read16()))
        self.trailing = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        w.write8(self.configuration_version)
        w.write8(self.avc_profile)
        w.write8(self.profile_compatibility)
        w.write8(self.avc_level)
        w.write8(0xFC | (self.length_size - 1))
        w.write8(0xE0 | len(self.sps_list))
        for sps in self.sps_list:
            w.write16(len(sps))
            w.write_bytes(sps)
        w.write8(len(self.pps_list))
        for pps in self.pps_list:
            w.write16(len(pps))
            w.write_bytes(pps)
        w.write_bytes(self.trailing)

    def all_nals(self) -> List[bytes]:
        return list(self.sps_list) + list(self.pps_list)


# --------------------------------------------------------------------------
# vvcC
# --------------------------------------------------------------------------

@register_box("vvcC")
class Box_vvcC(FullBox):
    """VVC decoder configuration record (ref: vvc_boxes.h:32 Box_vvcC,
    wire layout vvc_boxes.cc Box_vvcC::parse; ISO/IEC 14496-15 §11).

    Carries the VvcPTLRecord plus SPS/PPS/APS NAL arrays, mirroring the
    hvcC structure with VVC's 6-bit NAL types.
    """

    def __init__(self):
        super().__init__()
        self.length_size = 4
        self.ptl_present = True
        self.ols_idx = 0
        self.num_sublayers = 1
        self.constant_frame_rate = 0
        self.chroma_format_idc = 1
        self.bit_depth_minus8 = 0
        # VvcPTLRecord
        self.general_profile_idc = 1     # Main 10
        self.general_tier_flag = 0
        self.general_level_idc = 51
        self.ptl_frame_only_constraint = 1
        self.ptl_multi_layer_enabled = 0
        self.general_constraint_info = b"\x00"   # >=1 byte required
        self.sublayer_level_present: List[bool] = []
        self.sublayer_level_idc: List[int] = []
        self.sub_profiles: List[int] = []
        self.max_picture_width = 0
        self.max_picture_height = 0
        self.avg_frame_rate = 0
        # NAL arrays: list of (array_completeness, nal_unit_type, [nals])
        self.nal_arrays: List[Tuple[int, int, List[bytes]]] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        b = r.read8()
        self.length_size = ((b >> 1) & 3) + 1
        self.ptl_present = bool(b & 1)
        if self.ptl_present:
            word = r.read16()
            self.ols_idx = (word >> 7) & 0x1FF
            self.num_sublayers = (word >> 4) & 0x7
            self.constant_frame_rate = (word >> 2) & 0x3
            self.chroma_format_idc = word & 0x3
            self.bit_depth_minus8 = (r.read8() >> 5) & 0x7
            num_ci = r.read8() & 0x3F
            if num_ci == 0:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    "vvcC with num_bytes_constraint_info==0")
            b = r.read8()
            self.general_profile_idc = (b >> 1) & 0x7F
            self.general_tier_flag = b & 1
            self.general_level_idc = r.read8()
            ci = bytearray()
            for i in range(num_ci):
                byte = r.read8()
                if i == 0:
                    self.ptl_frame_only_constraint = (byte >> 7) & 1
                    self.ptl_multi_layer_enabled = (byte >> 6) & 1
                    byte &= 0x3F
                ci.append(byte)
            self.general_constraint_info = bytes(ci)
            self.sublayer_level_present = []
            if self.num_sublayers > 1:
                b = r.read8()
                mask = 0x80
                flags = [False] * (self.num_sublayers - 1)
                for i in range(self.num_sublayers - 2, -1, -1):
                    flags[i] = bool(b & mask)
                    mask >>= 1
                self.sublayer_level_present = flags
            self.sublayer_level_idc = [0] * self.num_sublayers
            if self.num_sublayers > 0:
                self.sublayer_level_idc[-1] = self.general_level_idc
                for i in range(self.num_sublayers - 2, -1, -1):
                    if i < len(self.sublayer_level_present) and \
                            self.sublayer_level_present[i]:
                        self.sublayer_level_idc[i] = r.read8()
                    else:
                        self.sublayer_level_idc[i] = \
                            self.sublayer_level_idc[i + 1]
            n_sub = r.read8()
            self.sub_profiles = [r.read32() for _ in range(n_sub)]
            self.max_picture_width = r.read16()
            self.max_picture_height = r.read16()
            self.avg_frame_rate = r.read16()
        else:
            raise HeifError.unsupported(
                SubError.Unsupported_data_version,
                "vvcC with ptl_present_flag=0 is not supported")

        n_arrays = r.read8()
        self.nal_arrays = []
        for _ in range(n_arrays):
            b = r.read8()
            completeness = (b >> 7) & 1
            nal_type = b & 0x3F
            n_units = r.read16()
            nals = []
            for _ in range(n_units):
                size = r.read16()
                if size == 0:
                    continue
                nals.append(r.read_bytes(size))
            self.nal_arrays.append((completeness, nal_type, nals))

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write8(0xF8 | ((self.length_size - 1) << 1) |
                 (1 if self.ptl_present else 0))
        if self.ptl_present:
            w.write16(((self.ols_idx & 0x1FF) << 7) |
                      ((self.num_sublayers & 0x7) << 4) |
                      ((self.constant_frame_rate & 0x3) << 2) |
                      (self.chroma_format_idc & 0x3))
            w.write8((self.bit_depth_minus8 & 0x7) << 5 | 0x1F)
            ci = self.general_constraint_info or b"\x00"
            w.write8(len(ci) & 0x3F)
            w.write8(((self.general_profile_idc & 0x7F) << 1) |
                     (self.general_tier_flag & 1))
            w.write8(self.general_level_idc)
            for i, byte in enumerate(ci):
                if i == 0:
                    byte = (byte & 0x3F) | \
                        ((self.ptl_frame_only_constraint & 1) << 7) | \
                        ((self.ptl_multi_layer_enabled & 1) << 6)
                w.write8(byte)
            if self.num_sublayers > 1:
                b = 0
                mask = 0x80
                for i in range(self.num_sublayers - 2, -1, -1):
                    if i < len(self.sublayer_level_present) and \
                            self.sublayer_level_present[i]:
                        b |= mask
                    mask >>= 1
                w.write8(b)
                for i in range(self.num_sublayers - 2, -1, -1):
                    if i < len(self.sublayer_level_present) and \
                            self.sublayer_level_present[i]:
                        w.write8(self.sublayer_level_idc[i])
            w.write8(len(self.sub_profiles))
            for sp in self.sub_profiles:
                w.write32(sp)
            w.write16(self.max_picture_width)
            w.write16(self.max_picture_height)
            w.write16(self.avg_frame_rate)
        w.write8(len(self.nal_arrays))
        for completeness, nal_type, nals in self.nal_arrays:
            w.write8(((completeness & 1) << 7) | (nal_type & 0x3F))
            w.write16(len(nals))
            for nal in nals:
                w.write16(len(nal))
                w.write_bytes(nal)

    def get_header_nals(self) -> List[bytes]:
        out = []
        for _, _, nals in self.nal_arrays:
            out.extend(nals)
        return out

    def add_nal(self, nal: bytes) -> None:
        """File NAL into its type array (VVC nal type = byte1 >> 3)."""
        nal_type = (nal[1] >> 3) & 0x1F if len(nal) >= 2 else 0
        for i, (comp, t, nals) in enumerate(self.nal_arrays):
            if t == nal_type:
                nals.append(nal)
                return
        self.nal_arrays.append((1, nal_type, [nal]))

    def dump_fields(self) -> List[str]:
        return [f"profile: {self.general_profile_idc}, "
                f"level: {self.general_level_idc}, "
                f"chroma: {self.chroma_format_idc}, "
                f"depth: {self.bit_depth_minus8 + 8}",
                f"size: {self.max_picture_width}x{self.max_picture_height}",
                f"nal arrays: {[(t, len(n)) for _, t, n in self.nal_arrays]}"]


def emulation_prevention_positions(nal: bytes) -> List[int]:
    """Indices of the 0x000003 emulation-prevention bytes: candidate
    00 00 03 triplets, then a scalar pass over the rare overlapping
    chains (00 00 03 00 00 03 is two, 00 00 00 03 03 one)."""
    a = np.frombuffer(nal, np.uint8)
    if len(a) < 3:
        return []
    cand = np.nonzero((a[2:] == 3) & (a[1:-1] == 0) & (a[:-2] == 0))[0] + 2
    out = []
    last = -10
    for i in cand.tolist():
        if i - last <= 2:
            # the zeros before it may belong to the previous EPB: recount
            zeros = 0
            for j in range(last + 1, i):
                zeros = zeros + 1 if nal[j] == 0 else 0
            if zeros >= 2:
                out.append(i)
                last = i
        else:
            out.append(i)
            last = i
    return out


def remove_emulation_prevention(nal: bytes) -> bytes:
    """Strip the 0x000003 emulation-prevention bytes (NAL → RBSP)."""
    pos = emulation_prevention_positions(nal)
    if not pos:
        return nal
    a = np.frombuffer(nal, np.uint8)
    mask = np.ones(len(a), bool)
    mask[np.asarray(pos, np.int64)] = False
    return a[mask].tobytes()


@dataclass
class HevcSpsSummary:
    """Fields of an H.265 SPS needed for configuration and security checks
    (ref: parse_sps_for_hvcC_configuration, hevc_boxes.cc:609+)."""

    video_parameter_set_id: int = 0
    max_sub_layers: int = 1
    profile_space: int = 0
    tier_flag: int = 0
    profile_idc: int = 0
    profile_compatibility_flags: int = 0
    constraint_indicator_flags: int = 0
    level_idc: int = 0
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: bool = False
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    conformance_window: Tuple[int, int, int, int] = (0, 0, 0, 0)  # l,r,t,b
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8

    @property
    def cropped_size(self) -> Tuple[int, int]:
        sub_w = 2 if self.chroma_format_idc in (1, 2) else 1
        sub_h = 2 if self.chroma_format_idc == 1 else 1
        l, rr, t, b = self.conformance_window
        return (self.pic_width_in_luma_samples - sub_w * (l + rr),
                self.pic_height_in_luma_samples - sub_h * (t + b))


def parse_hevc_sps(nal: bytes) -> HevcSpsSummary:
    """Parse the head of an H.265 SPS NAL (incl. 2-byte NAL header).

    Implements ITU-T H.265 §7.3.2.2.1 up to the conformance window and
    bit depths — everything hvcC configuration and the decoded-size
    security check need (ref: hevc_boxes.cc:609, hevc_dec.cc:54).
    """
    if len(nal) < 3:
        raise HeifError.invalid_input(msg="SPS NAL too short")
    rbsp = remove_emulation_prevention(nal[2:])  # skip NAL header
    br = BitReader(rbsp)
    s = HevcSpsSummary()
    s.video_parameter_set_id = br.read_bits(4)
    s.max_sub_layers = br.read_bits(3) + 1
    temporal_id_nesting = br.read_bits(1)  # noqa: F841
    # profile_tier_level(1, max_sub_layers-1)
    s.profile_space = br.read_bits(2)
    s.tier_flag = br.read_bits(1)
    s.profile_idc = br.read_bits(5)
    s.profile_compatibility_flags = br.read_bits(32)
    s.constraint_indicator_flags = (br.read_bits(32) << 16) | br.read_bits(16)
    s.level_idc = br.read_bits(8)
    sub_layer_profile_present = []
    sub_layer_level_present = []
    for _ in range(s.max_sub_layers - 1):
        sub_layer_profile_present.append(br.read_bits(1))
        sub_layer_level_present.append(br.read_bits(1))
    if s.max_sub_layers > 1:
        br.skip_bits(2 * (8 - (s.max_sub_layers - 1)))
    for i in range(s.max_sub_layers - 1):
        if sub_layer_profile_present[i]:
            br.skip_bits(2 + 1 + 5 + 32 + 48)
        if sub_layer_level_present[i]:
            br.skip_bits(8)
    s.seq_parameter_set_id = br.read_ue()
    s.chroma_format_idc = br.read_ue()
    if s.chroma_format_idc == 3:
        s.separate_colour_plane = bool(br.read_bits(1))
    s.pic_width_in_luma_samples = br.read_ue()
    s.pic_height_in_luma_samples = br.read_ue()
    if br.read_bits(1):  # conformance_window_flag
        s.conformance_window = (br.read_ue(), br.read_ue(),
                                br.read_ue(), br.read_ue())
    s.bit_depth_luma = br.read_ue() + 8
    s.bit_depth_chroma = br.read_ue() + 8
    return s


def hvcC_from_sps(sps: HevcSpsSummary) -> Box_hvcC:
    """Fill hvcC profile/level fields from a parsed SPS
    (ref: Box_hvcC configuration from SPS, hevc.cc:123-213)."""
    c = Box_hvcC()
    c.general_profile_space = sps.profile_space
    c.general_tier_flag = sps.tier_flag
    c.general_profile_idc = sps.profile_idc
    c.general_profile_compatibility_flags = sps.profile_compatibility_flags
    c.general_constraint_indicator_flags = sps.constraint_indicator_flags
    c.general_level_idc = sps.level_idc
    c.chroma_format = sps.chroma_format_idc
    c.bit_depth_luma = sps.bit_depth_luma
    c.bit_depth_chroma = sps.bit_depth_chroma
    return c
