"""Sequence (video track) boxes: the moov/trak/stbl family.

Counterpart of libheif_tpu/boxes/seq.py:19-974 (reference:
libheif/sequences/seq_boxes.{h,cc} — seq_boxes.h:33-1004), every class
whole: each box parses and writes its payload.  The track layer
(sequences/track.py) reads them.
"""

from __future__ import annotations

from typing import List

from ..core.bitstream import ByteReader, ByteWriter
from ..core.limits import SecurityLimits
from .box import Box, FullBox, register_box


@register_box("moov")
class Box_moov(Box):
    """Movie box (container)."""


@register_box("trak")
class Box_trak(Box):
    """Track box (container)."""


@register_box("mdia")
class Box_mdia(Box):
    """Media box (container)."""


@register_box("minf")
class Box_minf(Box):
    """Media information box (container)."""


@register_box("stbl")
class Box_stbl(Box):
    """Sample table box (container)."""


@register_box("edts")
class Box_edts(Box):
    """Edit box (container)."""


@register_box("mvhd")
class Box_mvhd(FullBox):
    """Movie header (ref: seq_boxes.h Box_mvhd)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.creation_time = 0
        self.modification_time = 0
        self.timescale = 90000
        self.duration = 0
        self.rate = 0x00010000
        self.volume = 0x0100
        self.matrix = [0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000]
        self.next_track_id = 1

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        if self.version == 1:
            self.creation_time = r.read64()
            self.modification_time = r.read64()
            self.timescale = r.read32()
            self.duration = r.read64()
        else:
            self.creation_time = r.read32()
            self.modification_time = r.read32()
            self.timescale = r.read32()
            self.duration = r.read32()
        self.rate = r.read32()
        self.volume = r.read16()
        r.skip(2 + 8)  # reserved
        self.matrix = [r.read32s() for _ in range(9)]
        r.skip(4 * 6)  # pre_defined
        self.next_track_id = r.read32()

    def derive_version(self) -> None:
        big = max(self.creation_time, self.modification_time, self.duration)
        self.version = 1 if big > 0xFFFFFFFF else 0

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if self.version == 1:
            w.write64(self.creation_time)
            w.write64(self.modification_time)
            w.write32(self.timescale)
            w.write64(self.duration)
        else:
            w.write32(self.creation_time)
            w.write32(self.modification_time)
            w.write32(self.timescale)
            w.write32(self.duration)
        w.write32(self.rate)
        w.write16(self.volume)
        w.write16(0)
        w.write64(0)
        for m in self.matrix:
            w.write32s(m)
        for _ in range(6):
            w.write32(0)
        w.write32(self.next_track_id)


@register_box("tkhd")
class Box_tkhd(FullBox):
    """Track header (ref: seq_boxes.h Box_tkhd)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.flags = 7          # enabled | in_movie | in_preview
        self.creation_time = 0
        self.modification_time = 0
        self.track_id = 1
        self.duration = 0
        self.layer = 0
        self.alternate_group = 0
        self.volume = 0
        self.matrix = [0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000]
        self.width = 0          # 16.16 fixed
        self.height = 0

    def parse_payload(self, r, limits, depth=0):
        if self.version == 1:
            self.creation_time = r.read64()
            self.modification_time = r.read64()
            self.track_id = r.read32()
            r.skip(4)
            self.duration = r.read64()
        else:
            self.creation_time = r.read32()
            self.modification_time = r.read32()
            self.track_id = r.read32()
            r.skip(4)
            self.duration = r.read32()
        r.skip(8)
        self.layer = r.read16()
        self.alternate_group = r.read16()
        self.volume = r.read16()
        r.skip(2)
        self.matrix = [r.read32s() for _ in range(9)]
        self.width = r.read32()
        self.height = r.read32()

    def derive_version(self):
        big = max(self.creation_time, self.modification_time, self.duration)
        self.version = 1 if big > 0xFFFFFFFF else 0

    def write_payload(self, w):
        self.write_full_header(w)
        if self.version == 1:
            w.write64(self.creation_time)
            w.write64(self.modification_time)
            w.write32(self.track_id)
            w.write32(0)
            w.write64(self.duration)
        else:
            w.write32(self.creation_time)
            w.write32(self.modification_time)
            w.write32(self.track_id)
            w.write32(0)
            w.write32(self.duration)
        w.write64(0)
        w.write16(self.layer)
        w.write16(self.alternate_group)
        w.write16(self.volume)
        w.write16(0)
        for m in self.matrix:
            w.write32s(m)
        w.write32(self.width)
        w.write32(self.height)

    def dump_fields(self):
        return [f"track_id={self.track_id}", f"duration={self.duration}",
                f"size={self.width >> 16}x{self.height >> 16}"]


@register_box("mdhd")
class Box_mdhd(FullBox):
    """Media header (ref: seq_boxes.h Box_mdhd)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.creation_time = 0
        self.modification_time = 0
        self.timescale = 90000
        self.duration = 0
        self.language = "und"

    def parse_payload(self, r, limits, depth=0):
        if self.version == 1:
            self.creation_time = r.read64()
            self.modification_time = r.read64()
            self.timescale = r.read32()
            self.duration = r.read64()
        else:
            self.creation_time = r.read32()
            self.modification_time = r.read32()
            self.timescale = r.read32()
            self.duration = r.read32()
        lang = r.read16()
        self.language = "".join(chr(((lang >> s) & 0x1F) + 0x60)
                                for s in (10, 5, 0))
        r.skip(2)

    def derive_version(self):
        big = max(self.creation_time, self.modification_time, self.duration)
        self.version = 1 if big > 0xFFFFFFFF else 0

    def write_payload(self, w):
        self.write_full_header(w)
        if self.version == 1:
            w.write64(self.creation_time)
            w.write64(self.modification_time)
            w.write32(self.timescale)
            w.write64(self.duration)
        else:
            w.write32(self.creation_time)
            w.write32(self.modification_time)
            w.write32(self.timescale)
            w.write32(self.duration)
        lang = 0
        for i, ch in enumerate(self.language[:3]):
            lang |= (ord(ch) - 0x60) << (10 - 5 * i)
        w.write16(lang)
        w.write16(0)

    def dump_fields(self):
        return [f"timescale={self.timescale}", f"duration={self.duration}",
                f"language={self.language}"]


@register_box("vmhd")
class Box_vmhd(FullBox):
    """Video media header."""

    def __init__(self):
        super().__init__()
        self.flags = 1
        self.graphics_mode = 0
        self.op_color = (0, 0, 0)

    def parse_payload(self, r, limits, depth=0):
        self.graphics_mode = r.read16()
        self.op_color = tuple(r.read16() for _ in range(3))

    def write_payload(self, w):
        self.write_full_header(w)
        w.write16(self.graphics_mode)
        for c in self.op_color:
            w.write16(c)


@register_box("nmhd")
class Box_nmhd(FullBox):
    """Null media header (metadata tracks)."""

    def parse_payload(self, r, limits, depth=0):
        pass

    def write_payload(self, w):
        self.write_full_header(w)


class VisualSampleEntry(Box):
    """Coded video sample entry (hvc1/av01/...); children carry the
    codec configuration (ref: seq_boxes.h VisualSampleEntry)."""

    def __init__(self, fourcc: str = "hvc1"):
        super().__init__()
        self.box_type = fourcc
        self.data_reference_index = 1
        self.width = 0
        self.height = 0
        self.compressor_name = ""

    def parse_payload(self, r, limits, depth=0):
        r.skip(6)
        self.data_reference_index = r.read16()
        r.skip(2 + 2 + 12)      # pre_defined/reserved
        self.width = r.read16()
        self.height = r.read16()
        r.skip(4 + 4 + 4 + 2)   # resolutions, reserved, frame_count
        name = r.read_bytes(32)
        n = name[0]
        self.compressor_name = name[1:1 + min(n, 31)].decode(
            "utf-8", "replace")
        r.skip(2 + 2)           # depth, pre_defined
        self.read_children(r, limits, depth + 1)

    def write_payload(self, w):
        w.write_bytes(b"\x00" * 6)
        w.write16(self.data_reference_index)
        w.write_bytes(b"\x00" * 16)
        w.write16(self.width)
        w.write16(self.height)
        w.write32(0x00480000)
        w.write32(0x00480000)
        w.write32(0)
        w.write16(1)
        name = self.compressor_name.encode()[:31]
        w.write_bytes(bytes([len(name)]) + name + b"\x00" * (31 - len(name)))
        w.write16(0x0018)
        w.write16s(-1)
        self.write_children(w)

    def dump_fields(self):
        return [f"size={self.width}x{self.height}",
                f"compressor={self.compressor_name!r}"]


# avc3 (parameter sets in band) and vvi1 beside the JAX package's list,
# which leaves them out, so that such tracks open (its track code reads
# both)
for _fourcc in ("hvc1", "hev1", "av01", "avc1", "avc3", "vvc1", "vvi1",
                "mjpg", "j2ki", "uncv"):
    register_box(_fourcc)(type(f"Box_{_fourcc}", (VisualSampleEntry,), {
        "__init__": (lambda fc: lambda self: VisualSampleEntry.__init__(
            self, fc))(_fourcc)}))


@register_box("stsd")
class Box_stsd(FullBox):
    """Sample description (entries are sample-entry boxes)."""

    def parse_payload(self, r, limits, depth=0):
        count = r.read32()
        self.read_children(r, limits, depth + 1)
        if len(self.children) != count:
            pass  # tolerated; dump shows actual children

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.children))
        self.write_children(w)


@register_box("stts")
class Box_stts(FullBox):
    """Decoding time-to-sample (ref: seq_boxes.h Box_stts)."""

    def __init__(self):
        super().__init__()
        self.entries = []        # (sample_count, sample_delta)

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 8, "stts entries")
        self.entries = [(r.read32(), r.read32()) for _ in range(n)]

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.entries))
        for c, d in self.entries:
            w.write32(c)
            w.write32(d)

    def total_samples(self) -> int:
        return sum(c for c, _ in self.entries)

    def total_duration(self) -> int:
        return sum(c * d for c, d in self.entries)

    def sample_duration(self, idx: int) -> int:
        for c, d in self.entries:
            if idx < c:
                return d
            idx -= c
        return self.entries[-1][1] if self.entries else 0

    def dump_fields(self):
        return [f"entries={self.entries[:4]}…" if len(self.entries) > 4
                else f"entries={self.entries}"]


@register_box("ctts")
class Box_ctts(FullBox):
    """Composition time offsets."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.entries = []        # (sample_count, offset)

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 8, "ctts entries")
        if self.version == 0:
            self.entries = [(r.read32(), r.read32()) for _ in range(n)]
        else:
            self.entries = [(r.read32(), r.read32s()) for _ in range(n)]

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.entries))
        for c, o in self.entries:
            w.write32(c)
            if self.version == 0:
                w.write32(o)
            else:
                w.write32s(o)


@register_box("stsc")
class Box_stsc(FullBox):
    """Sample-to-chunk (ref: seq_boxes.h Box_stsc)."""

    def __init__(self):
        super().__init__()
        self.entries = []  # (first_chunk, samples_per_chunk, desc_index)

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 12, "stsc entries")
        self.entries = [(r.read32(), r.read32(), r.read32())
                        for _ in range(n)]

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.entries))
        for a, b, c in self.entries:
            w.write32(a)
            w.write32(b)
            w.write32(c)


@register_box("stsz")
class Box_stsz(FullBox):
    """Sample sizes."""

    def __init__(self):
        super().__init__()
        self.uniform_size = 0
        self.sizes = []

    def parse_payload(self, r, limits, depth=0):
        self.uniform_size = r.read32()
        n = r.read32()
        if self.uniform_size == 0:
            limits.check_block_size(n * 4, "stsz entries")
            self.sizes = [r.read32() for _ in range(n)]
        else:
            self.sizes = []
            self.sample_count = n

    def sample_size(self, idx: int) -> int:
        if self.uniform_size:
            return self.uniform_size
        return self.sizes[idx]

    def num_samples(self) -> int:
        if self.uniform_size:
            return getattr(self, "sample_count", 0)
        return len(self.sizes)

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(self.uniform_size)
        if self.uniform_size:
            w.write32(getattr(self, "sample_count", 0))
        else:
            w.write32(len(self.sizes))
            for s in self.sizes:
                w.write32(s)


@register_box("stco")
class Box_stco(FullBox):
    """Chunk offsets (32-bit)."""

    def __init__(self):
        super().__init__()
        self.offsets = []

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 4, "stco entries")
        self.offsets = [r.read32() for _ in range(n)]

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.offsets))
        for o in self.offsets:
            w.write32(o)


@register_box("co64")
class Box_co64(FullBox):
    """Chunk offsets (64-bit)."""

    def __init__(self):
        super().__init__()
        self.offsets = []

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 8, "co64 entries")
        self.offsets = [r.read64() for _ in range(n)]

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.offsets))
        for o in self.offsets:
            w.write64(o)


@register_box("stss")
class Box_stss(FullBox):
    """Sync (key frame) sample numbers (1-based)."""

    def __init__(self):
        super().__init__()
        self.samples = []

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 4, "stss entries")
        self.samples = [r.read32() for _ in range(n)]

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.samples))
        for s in self.samples:
            w.write32(s)


@register_box("ccst")
class Box_ccst(FullBox):
    """Coding constraints (ref: seq_boxes.h Box_ccst)."""

    def __init__(self):
        super().__init__()
        self.all_ref_pics_intra = True
        self.intra_pred_used = True
        self.max_ref_per_pic = 0

    def parse_payload(self, r, limits, depth=0):
        v = r.read32()
        self.all_ref_pics_intra = bool(v & 0x80000000)
        self.intra_pred_used = bool(v & 0x40000000)
        self.max_ref_per_pic = (v >> 26) & 0xF

    def write_payload(self, w):
        self.write_full_header(w)
        v = (0x80000000 if self.all_ref_pics_intra else 0) | \
            (0x40000000 if self.intra_pred_used else 0) | \
            (self.max_ref_per_pic << 26)
        w.write32(v)


@register_box("elst")
class Box_elst(FullBox):
    """Edit list."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.entries = []  # (segment_duration, media_time, rate_int, rate_frac)

    def parse_payload(self, r, limits, depth=0):
        n = r.read32()
        limits.check_block_size(n * 20, "elst entries")
        out = []
        for _ in range(n):
            if self.version == 1:
                dur = r.read64()
                mt = r.read64s()
            else:
                dur = r.read32()
                mt = r.read32s()
            out.append((dur, mt, r.read16(), r.read16()))
        self.entries = out

    def write_payload(self, w):
        self.write_full_header(w)
        w.write32(len(self.entries))
        for dur, mt, ri, rf in self.entries:
            if self.version == 1:
                w.write64(dur)
                w.write64(mt if mt >= 0 else (1 << 64) + mt)
            else:
                w.write32(dur)
                w.write32s(mt)
            w.write16(ri)
            w.write16(rf)


# --------------------------------------------------------------------------
# Sample auxiliary information (saiz/saio) — carries per-sample TAI
# timestamps ('stai') and GIMI content IDs ('suid')
# (ref: seq_boxes.h:839 Box_saiz, :882 Box_saio; track.cc:65
# SampleAuxInfoHelper, track.cc:154 SampleAuxInfoReader).
# --------------------------------------------------------------------------

@register_box("saiz")
class Box_saiz(FullBox):
    """Sample auxiliary information sizes."""

    def __init__(self):
        super().__init__()
        self.aux_info_type = ""         # 4cc, present when flags&1
        self.aux_info_type_parameter = 0
        self.default_sample_info_size = 0
        self.sample_count = 0
        self.sample_sizes: List[int] = []   # used when default size == 0

    def set_aux_info_type(self, fourcc_str: str, parameter: int = 0) -> None:
        self.aux_info_type = fourcc_str
        self.aux_info_type_parameter = parameter
        self.flags |= 1

    def sample_info_size(self, idx: int) -> int:
        if self.default_sample_info_size:
            return self.default_sample_info_size
        if idx < len(self.sample_sizes):
            return self.sample_sizes[idx]
        return 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        if self.flags & 1:
            self.aux_info_type = r.read_fixed_string(4)
            self.aux_info_type_parameter = r.read32()
        self.default_sample_info_size = r.read8()
        self.sample_count = r.read32()
        if self.default_sample_info_size == 0:
            limits.check_block_size(self.sample_count, "saiz entries")
            self.sample_sizes = [r.read8() for _ in range(self.sample_count)]

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if self.flags & 1:
            w.write_fixed_string(self.aux_info_type, 4)
            w.write32(self.aux_info_type_parameter)
        w.write8(self.default_sample_info_size)
        if self.default_sample_info_size:
            w.write32(self.sample_count)
        else:
            w.write32(len(self.sample_sizes))
            for s in self.sample_sizes:
                w.write8(s)

    def dump_fields(self) -> List[str]:
        return [f"aux_info_type: {self.aux_info_type}",
                f"default_sample_info_size: {self.default_sample_info_size}",
                f"sample_count: {self.sample_count or len(self.sample_sizes)}"]


@register_box("saio")
class Box_saio(FullBox):
    """Sample auxiliary information offsets."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.aux_info_type = ""
        self.aux_info_type_parameter = 0
        self.offsets: List[int] = []
        # write-path patching: positions of offset fields in the stream
        self._patch_positions: List[int] = []

    def set_aux_info_type(self, fourcc_str: str, parameter: int = 0) -> None:
        self.aux_info_type = fourcc_str
        self.aux_info_type_parameter = parameter
        self.flags |= 1

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        if self.flags & 1:
            self.aux_info_type = r.read_fixed_string(4)
            self.aux_info_type_parameter = r.read32()
        n = r.read32()
        limits.check_block_size(n * 8, "saio entries")
        if self.version == 1:
            self.offsets = [r.read64() for _ in range(n)]
        else:
            self.offsets = [r.read32() for _ in range(n)]

    def derive_version(self) -> None:
        self.version = 1 if any(o > 0xFFFFFFFF for o in self.offsets) else 0

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        if self.flags & 1:
            w.write_fixed_string(self.aux_info_type, 4)
            w.write32(self.aux_info_type_parameter)
        w.write32(len(self.offsets))
        self._patch_positions = []
        for o in self.offsets:
            self._patch_positions.append(w.pos)
            if self.version == 1:
                w.write64(o)
            else:
                w.write32(o)


@register_box("sbgp")
class Box_sbgp(FullBox):
    """Sample-to-group (ref: seq_boxes.h:722)."""

    supported_versions = (0, 1)

    def __init__(self):
        super().__init__()
        self.grouping_type = ""
        self.grouping_type_parameter = 0
        self.entries: List[tuple] = []   # (sample_count, group_descr_index)

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.grouping_type = r.read_fixed_string(4)
        if self.version == 1:
            self.grouping_type_parameter = r.read32()
        n = r.read32()
        limits.check_block_size(n * 8, "sbgp entries")
        self.entries = [(r.read32(), r.read32()) for _ in range(n)]

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_fixed_string(self.grouping_type, 4)
        if self.version == 1:
            w.write32(self.grouping_type_parameter)
        w.write32(len(self.entries))
        for count, gdi in self.entries:
            w.write32(count)
            w.write32(gdi)

    def dump_fields(self) -> List[str]:
        return [f"grouping_type: {self.grouping_type}",
                f"entries: {len(self.entries)}"]


@register_box("sgpd")
class Box_sgpd(FullBox):
    """Sample group description (ref: seq_boxes.h:783).

    Group-description payloads are kept as raw bytes; 'refs' (direct
    reference samples) entries are decoded on demand by the track layer.
    """

    supported_versions = (1, 2)

    def __init__(self):
        super().__init__()
        self.version = 1
        self.grouping_type = ""
        self.default_length = 0
        self.default_group_description_index = 0
        self.entries: List[bytes] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.grouping_type = r.read_fixed_string(4)
        if self.version >= 1:
            self.default_length = r.read32()
        if self.version >= 2:
            self.default_group_description_index = r.read32()
        n = r.read32()
        limits.check_block_size(n * max(1, self.default_length),
                                "sgpd entries")
        out = []
        for _ in range(n):
            length = self.default_length
            if self.version >= 1 and self.default_length == 0:
                length = r.read32()
            out.append(r.read_bytes(length))
        self.entries = out

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_fixed_string(self.grouping_type, 4)
        if self.version >= 1:
            w.write32(self.default_length)
        if self.version >= 2:
            w.write32(self.default_group_description_index)
        w.write32(len(self.entries))
        for e in self.entries:
            if self.version >= 1 and self.default_length == 0:
                w.write32(len(e))
            w.write_bytes(e)

    def dump_fields(self) -> List[str]:
        return [f"grouping_type: {self.grouping_type}",
                f"entries: {len(self.entries)}"]


@register_box("sdtp")
class Box_sdtp(FullBox):
    """Independent and disposable samples (ref: seq_boxes.h:927).

    One byte per sample; the sample count comes from stsz, so the raw
    payload is preserved verbatim.
    """

    def __init__(self):
        super().__init__()
        self.sample_flags = b""

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.sample_flags = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_bytes(self.sample_flags)

    def sample_is_independent(self, idx: int) -> bool:
        if idx >= len(self.sample_flags):
            return True
        return ((self.sample_flags[idx] >> 4) & 3) == 2


class TrackReferenceTypeBox(Box):
    """One reference-type edge inside tref: box type IS the ref type
    ('auxl', 'cdsc', 'thmb', 'vdep', ...), payload = referenced ids."""

    def __init__(self, ref_type: str = "auxl"):
        super().__init__()
        self.box_type = ref_type
        self.track_ids: List[int] = []

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        ids = []
        while not r.eof() and r.remaining() >= 4:
            ids.append(r.read32())
        self.track_ids = ids

    def write_payload(self, w: ByteWriter) -> None:
        for t in self.track_ids:
            w.write32(t)

    def dump_fields(self) -> List[str]:
        return [f"ref_type: {self.box_type}", f"track_ids: {self.track_ids}"]


@register_box("tref")
class Box_tref(Box):
    """Track reference container (ref: seq_boxes.h:956).

    Children are TrackReferenceTypeBoxes whose box type is the
    reference kind, so the generic child parser cannot be used.
    """

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        while not r.eof() and r.remaining() >= 8:
            size = r.read32()
            rtype = r.read_fixed_string(4)
            if size < 8 or size - 8 > r.remaining():
                break
            sub = r.sub_reader(size - 8)
            ref = TrackReferenceTypeBox(rtype)
            ref.parse_payload(sub, limits, depth + 1)
            self.children.append(ref)

    def write_payload(self, w: ByteWriter) -> None:
        for c in self.children:
            payload = ByteWriter()
            c.write_payload(payload)
            w.write32(8 + len(payload))
            w.write_fixed_string(c.box_type, 4)
            w.write_bytes(payload.data())

    def references_of_type(self, ref_type: str) -> List[int]:
        for c in self.children:
            if c.box_type == ref_type:
                return list(c.track_ids)
        return []

    def reference_types(self) -> List[str]:
        return [c.box_type for c in self.children]

    def add_references(self, ref_type: str, to_track_ids: List[int]) -> None:
        for c in self.children:
            if c.box_type == ref_type:
                c.track_ids.extend(to_track_ids)
                return
        ref = TrackReferenceTypeBox(ref_type)
        ref.track_ids = list(to_track_ids)
        self.children.append(ref)


@register_box("auxi")
class Box_auxi(FullBox):
    """Auxiliary track type URN (ref: seq_boxes.h:595 Box_auxi),
    the track analog of the auxC item property."""

    def __init__(self, aux_track_type: str = ""):
        super().__init__()
        self.aux_track_type = aux_track_type

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.aux_track_type = r.read_string()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_string(self.aux_track_type)

    def dump_fields(self) -> List[str]:
        return [f"aux_track_type: {self.aux_track_type}"]


@register_box("uri ")
class Box_uri(FullBox):
    """URI box inside a urim sample entry (ref: seq_boxes.h:696)."""

    def __init__(self, uri: str = ""):
        super().__init__()
        self.uri = uri

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.uri = r.read_string()

    def write_payload(self, w: ByteWriter) -> None:
        self.write_full_header(w)
        w.write_string(self.uri)

    def dump_fields(self) -> List[str]:
        return [f"uri: {self.uri}"]


@register_box("urim")
class Box_urim(Box):
    """URIMetaSampleEntry (ref: seq_boxes.h:673): plain SampleEntry
    header followed by a uri box child."""

    def __init__(self):
        super().__init__()
        self.box_type = "urim"
        self.data_reference_index = 1

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        r.skip(6)
        self.data_reference_index = r.read16()
        self.read_children(r, limits, depth + 1)

    def write_payload(self, w: ByteWriter) -> None:
        for _ in range(6):
            w.write8(0)
        w.write16(self.data_reference_index)
        self.write_children(w)

    def get_uri(self) -> str:
        u = self.get_child("uri ")
        return u.uri if u is not None else ""


@register_box("btrt")
class Box_btrt(Box):
    """Bitrate box (ref: seq_boxes.h:816)."""

    def __init__(self):
        super().__init__()
        self.buffer_size_db = 0
        self.max_bitrate = 0
        self.avg_bitrate = 0

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.buffer_size_db = r.read32()
        self.max_bitrate = r.read32()
        self.avg_bitrate = r.read32()

    def write_payload(self, w: ByteWriter) -> None:
        w.write32(self.buffer_size_db)
        w.write32(self.max_bitrate)
        w.write32(self.avg_bitrate)

    def dump_fields(self) -> List[str]:
        return [f"buffer_size_db: {self.buffer_size_db}",
                f"max_bitrate: {self.max_bitrate}",
                f"avg_bitrate: {self.avg_bitrate}"]
