"""Track runtime, read side: sample tables to decodable frame sequences.

Counterpart of libheif_tpu/sequences/track.py:44-121, :148-621 (reference:
libheif/sequences/track.{h,cc} Track track.h:131, track_visual.cc:175
decode_next_image_sample, chunk.cc sample-extent mapping, track.cc:154
SampleAuxInfoReader, track.cc:1044 init_sample_timing_table).  The sample
geometry (stsc/stco/stsz/stts/ctts/stss) is flattened once into
per-sample extents, the edit list gives the repetitions, saiz/saio give
each sample's TAI timestamp ('stai') and GIMI content id ('suid'), and a
trak-level meta box the track's GIMI content id.

A track decodes its samples on its context's device (``None`` meaning
CUDA): ``uncv`` through the port's UnciDecoder, ``hvc1``/``hev1``
through the HEVC decoder (a track with non-sync samples through a
stateful sequence session, codecs/hevc/decoder.py HevcSequenceSession),
``av01`` one still a sample (a non-key sample fails as it does in the
JAX package, whose AV1 decoder has no sequence session), ``mjpg``
through the JPEG decoder, ``avc1``/``avc3`` through the AVC decoder (a
track with non-sync samples through its sequence session,
codecs/avc/decoder.py AvcSequenceSession, which takes in-band parameter
sets too), ``vvc1``/``vvi1`` one intra picture a sample through the VVC
decoder (as the JAX package's ``vvc1`` track; its context opens no
``vvi1`` track, having no such sample entry).  ``j2ki`` raises
Unsupported by name.

The write side (JAX track.py:111-146, :624-1015): ``TrackOptions``,
``VisualTrackWriter`` (``hvc1`` intra or inter through the registry's
HEVC encoder and its sequence session, ``avc1`` intra or IPPP through
the AVC encoder and its session, ``av01``, ``vvc1`` (all intra),
``mjpg``, ``uncv`` through
UnciEncoder; raw samples, track references, TAI/GIMI aux info through
``SampleAuxInfoWriter``, the GIMI track meta) and
``MetadataTrackWriter``.  A writer encodes on its context's device;
``j2k`` tracks raise Unsupported by name.  Its
spans are ``track.write`` (a frame's encode) and
``track.write.finalize`` (the trak tree, with the lookahead's last
frames).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .._build import resolve_device
from ..codecs import registry
from ..codecs.unc import UnciEncoder
from ..core import trace
from ..core.error import ErrorCode, HeifError, SubError
from ..boxes.box import Box
from ..boxes.meta import (Box_dinf, Box_dref, Box_hdlr, Box_idat, Box_iinf,
                          Box_iloc, Box_infe, Box_meta, Box_pitm, Box_taic,
                          Box_url, IlocExtent, IlocItem, TaiClockInfo,
                          TaiTimestampPacket)
from ..boxes.seq import (Box_auxi, Box_ccst, Box_ctts, Box_mdhd, Box_mdia,
                         Box_minf, Box_nmhd, Box_saio, Box_saiz, Box_stbl,
                         Box_stco, Box_stsc, Box_stsd, Box_stss, Box_stsz,
                         Box_stts, Box_tkhd, Box_trak, Box_tref, Box_uri,
                         Box_urim, Box_vmhd, VisualSampleEntry)
from ..image.pixel_image import image_on_device

GIMI_TRACK_CONTENT_ID_URI = "urn:uuid:15beb8e4-944d-5fc6-a3dd-cb5a7e655c73"

# auxiliary track type URNs (ref: track.cc get_track_auxiliary_info_type)
AUX_TYPE_ALPHA_HEVC = "urn:mpeg:hevc:2015:auxid:1"
AUX_TYPE_ALPHA_AVC = "urn:mpeg:avc:2015:auxid:1"
AUX_TYPE_ALPHA_MPEGB = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"

_ALPHA_AUX_URNS = (AUX_TYPE_ALPHA_HEVC, AUX_TYPE_ALPHA_AVC,
                   AUX_TYPE_ALPHA_MPEGB)

# sample entries the port does not read: JPEG 2000 (the JAX package maps
# ``j2ki`` to a codec with no decoder)
_UNPORTED_CODINGS = {"j2ki": "JPEG 2000"}
# sample entry -> the codec registry's format of its decoder
_CODING_FORMATS = {"hvc1": "hevc", "hev1": "hevc", "av01": "av1",
                   "mjpg": "jpeg", "avc1": "avc", "avc3": "avc",
                   "vvc1": "vvc", "vvi1": "vvc"}


@dataclass
class Sample:
    offset: int           # absolute file offset
    size: int
    duration: int         # in media timescale
    dts: int
    pts: int              # dts + ctts composition offset
    is_sync: bool
    desc_index: int
    chunk_index: int


@dataclass
class RawSequenceSample:
    """heif_raw_sequence_sample equivalent (ref: heif_sequences.h).
    is_sync marks random-access samples."""
    data: bytes = b""
    duration: int = 0
    timestamp: Optional[TaiTimestampPacket] = None
    gimi_sample_content_id: Optional[str] = None
    is_sync: bool = True


class SampleAuxInfoReader:
    """Maps saiz/saio to per-sample aux payloads
    (ref: track.cc:154 SampleAuxInfoReader).

    saio may carry a single base offset (contiguous block) or one
    offset per chunk; sizes come from saiz (0 = aux not present for
    that sample).
    """

    def __init__(self, saiz: Box_saiz, saio: Box_saio,
                 samples: List[Sample]):
        self.saiz = saiz
        self.saio = saio
        self.aux_info_type = saiz.aux_info_type
        self.aux_info_type_parameter = saiz.aux_info_type_parameter
        n = len(samples)
        sizes = [saiz.sample_info_size(i) for i in range(n)]
        offsets: List[int] = [0] * n
        if len(saio.offsets) == 1:
            pos = saio.offsets[0]
            for i in range(n):
                offsets[i] = pos
                pos += sizes[i]
        elif len(saio.offsets) >= 1:
            # one offset per chunk; samples advance within their chunk
            pos_in_chunk: Dict[int, int] = {}
            for i, s in enumerate(samples):
                ci = s.chunk_index
                if ci >= len(saio.offsets):
                    ci = len(saio.offsets) - 1
                base = saio.offsets[ci]
                off = pos_in_chunk.get(ci, base)
                offsets[i] = off
                pos_in_chunk[ci] = off + sizes[i]
        self.sizes = sizes
        self.offsets = offsets

    def get_sample_info(self, file, sample_idx: int) -> Optional[bytes]:
        if sample_idx >= len(self.sizes) or self.sizes[sample_idx] == 0:
            return None
        return bytes(file.read_file_range(self.offsets[sample_idx],
                                          self.sizes[sample_idx]))


class Track:
    """Base track model built from a trak box tree; ``device`` is where
    its samples decode (None means CUDA)."""

    def __init__(self, trak: Box, file, sequence_timescale: int = 0,
                 sequence_duration: int = 0, device=None):
        self.trak = trak
        self.file = file
        self.device = device
        self.tkhd: Box_tkhd = trak.get_child("tkhd", required=True)
        mdia = trak.get_child("mdia", required=True)
        self.mdhd: Box_mdhd = mdia.get_child("mdhd", required=True)
        hdlr = mdia.get_child("hdlr")
        self.handler = getattr(hdlr, "handler_type", "????") if hdlr else "????"
        minf = mdia.get_child("minf", required=True)
        stbl = minf.get_child("stbl", required=True)
        self.stbl = stbl
        self.stsd: Box_stsd = stbl.get_child("stsd", required=True)
        self.tref: Optional[Box_tref] = trak.get_child("tref")
        edts = trak.get_child("edts")
        self.elst = edts.get_child("elst") if edts is not None else None
        self.samples = self._flatten_samples(stbl)
        self._init_repetitions(sequence_timescale, sequence_duration)
        self._init_aux_readers(stbl)
        self._pos = 0

    # ------------------------------------------------------------- tables

    def _flatten_samples(self, stbl) -> List[Sample]:
        """stsc/stco/stsz/stts/ctts/stss → flat per-sample extents
        (ref: chunk.cc Chunk::get_data_extent_for_sample +
        track.cc:1044 media timeline)."""
        stsz: Box_stsz = stbl.get_child("stsz", required=True)
        stsc: Box_stsc = stbl.get_child("stsc", required=True)
        stco = stbl.get_child("stco") or stbl.get_child("co64")
        stts: Box_stts = stbl.get_child("stts", required=True)
        stss: Optional[Box_stss] = stbl.get_child("stss")
        ctts: Optional[Box_ctts] = stbl.get_child("ctts")
        if stco is None:
            raise HeifError.invalid_input(msg="track without chunk offsets")

        n = stsz.num_samples()
        sync = set(stss.samples) if stss else None
        cts_offsets = self._expand_ctts(ctts, n)
        # expand stsc runs over the chunk list
        chunks = stco.offsets
        spc: List[Tuple[int, int]] = []   # per chunk: (samples, desc_idx)
        entries = stsc.entries
        for i, (first, count, desc) in enumerate(entries):
            last = entries[i + 1][0] - 1 if i + 1 < len(entries) \
                else len(chunks)
            for _ in range(first, last + 1):
                spc.append((count, desc))
        samples: List[Sample] = []
        si = 0
        dts = 0
        for ci, off in enumerate(chunks):
            if ci >= len(spc):
                break
            count, desc = spc[ci]
            pos = off
            for _ in range(count):
                if si >= n:
                    break
                size = stsz.sample_size(si)
                dur = stts.sample_duration(si)
                samples.append(Sample(
                    offset=pos, size=size, duration=dur, dts=dts,
                    pts=dts + cts_offsets[si],
                    is_sync=(sync is None or (si + 1) in sync),
                    desc_index=desc, chunk_index=ci))
                pos += size
                dts += dur
                si += 1
        return samples

    @staticmethod
    def _expand_ctts(ctts: Optional[Box_ctts], n: int) -> List[int]:
        out = [0] * n
        if ctts is None:
            return out
        i = 0
        for count, offset in ctts.entries:
            for _ in range(count):
                if i >= n:
                    return out
                out[i] = offset
                i += 1
        return out

    def _init_repetitions(self, seq_timescale: int, seq_duration: int) -> None:
        """Edit-list repeat handling (ref: track.cc:1084-1134).

        num_repetitions semantics: 1 = plays once (no elst), 0 = elst
        present but not an interpretable repeat pattern, 2^32-1 =
        indefinite.
        """
        self.num_repetitions = 1
        media_dur = sum(s.duration for s in self.samples)
        if self.elst is None:
            return
        entries = self.elst.entries
        repeat = bool(self.elst.flags & 1)   # repeat-mode flag
        if (seq_timescale == self.timescale and len(entries) == 1 and
                entries[0][1] == 0 and entries[0][0] == self.mdhd.duration
                and repeat and media_dur > 0):
            if seq_duration >= 0xFFFFFFFFFFFFFFFF or \
                    seq_duration == 0xFFFFFFFF:
                self.num_repetitions = 0xFFFFFFFF
            else:
                mult = seq_duration // media_dur
                self.num_repetitions = min(mult, 0xFFFFFFFF)
        else:
            self.num_repetitions = 0

    def _init_aux_readers(self, stbl) -> None:
        """Pair saiz/saio boxes by aux type (ref: track.cc:463-510)."""
        self.aux_readers: List[SampleAuxInfoReader] = []
        self.tai_reader: Optional[SampleAuxInfoReader] = None
        self.gimi_reader: Optional[SampleAuxInfoReader] = None
        saizs = stbl.get_children("saiz")
        saios = stbl.get_children("saio")
        for saiz in saizs:
            saio = None
            for cand in saios:
                if (cand.aux_info_type == saiz.aux_info_type and
                        cand.aux_info_type_parameter ==
                        saiz.aux_info_type_parameter):
                    saio = cand
                    break
            if saio is None:
                raise HeifError.invalid_input(
                    msg="'saiz' box without matching 'saio' box.")
            reader = SampleAuxInfoReader(saiz, saio, self.samples)
            self.aux_readers.append(reader)
            if saiz.aux_info_type == "stai":
                self.tai_reader = reader
            elif saiz.aux_info_type == "suid":
                self.gimi_reader = reader

    # ---------------------------------------------------------------- api

    @property
    def track_id(self) -> int:
        return self.tkhd.track_id

    @property
    def timescale(self) -> int:
        return self.mdhd.timescale

    @property
    def num_samples(self) -> int:
        return len(self.samples)

    def duration(self) -> int:
        return sum(s.duration for s in self.samples)

    def duration_in_movie_units(self) -> int:
        return self.tkhd.duration

    def sample_duration(self, idx: int) -> int:
        return self.samples[idx].duration

    def sample_data(self, idx: int) -> bytes:
        s = self.samples[idx]
        return bytes(self.file.read_file_range(s.offset, s.size))

    # --- sample aux info ------------------------------------------------

    def sample_aux_info_types(self) -> List[Tuple[str, int]]:
        return [(r.aux_info_type, r.aux_info_type_parameter)
                for r in self.aux_readers]

    def sample_tai_timestamp(self, idx: int) -> Optional[TaiTimestampPacket]:
        if self.tai_reader is None:
            return None
        raw = self.tai_reader.get_sample_info(self.file, idx)
        if raw is None:
            return None
        return TaiTimestampPacket.from_bytes(raw)

    def sample_gimi_content_id(self, idx: int) -> Optional[str]:
        if self.gimi_reader is None:
            return None
        raw = self.gimi_reader.get_sample_info(self.file, idx)
        if raw is None:
            return None
        return raw.split(b"\0", 1)[0].decode("utf-8", "replace")

    def tai_clock_info(self) -> Optional[TaiClockInfo]:
        """taic box of the first sample entry (ref:
        heif_track_get_tai_clock_info_of_first_cluster)."""
        for entry in self.stsd.children:
            for c in getattr(entry, "children", []):
                if c.box_type == "taic":
                    return c.info
        return None

    def gimi_track_content_id(self) -> Optional[str]:
        """Track-level GIMI content ID from the trak meta box
        (ref: track.cc:522-554)."""
        meta = self.trak.get_child("meta")
        if meta is None:
            return None
        iinf = meta.get_child("iinf")
        iloc = meta.get_child("iloc")
        idat = meta.get_child("idat")
        if iinf is None or iloc is None:
            return None
        for infe in iinf.get_children("infe"):
            if infe.item_type == "uri " and \
                    getattr(infe, "item_uri_type", "") == \
                    GIMI_TRACK_CONTENT_ID_URI:
                it = iloc.find_item(infe.item_id)
                if it is None:
                    return None
                parts = []
                for ext in it.extents:
                    if it.construction_method == 1 and idat is not None:
                        data = idat.data[ext.offset:ext.offset + ext.length]
                    else:
                        data = self.file.read_file_range(
                            it.base_offset + ext.offset, ext.length)
                    parts.append(bytes(data))
                raw = b"".join(parts)
                return raw.split(b"\0", 1)[0].decode("utf-8", "replace")
        return None

    # --- track references -------------------------------------------------

    def reference_types(self) -> List[str]:
        return self.tref.reference_types() if self.tref else []

    def references_of_type(self, ref_type: str) -> List[int]:
        return self.tref.references_of_type(ref_type) if self.tref else []

    # --- raw sample iteration ---------------------------------------------

    def get_next_raw_sample(self) -> Optional[RawSequenceSample]:
        if self._pos >= len(self.samples):
            return None
        idx = self._pos
        self._pos += 1
        return RawSequenceSample(
            data=self.sample_data(idx),
            duration=self.samples[idx].duration,
            timestamp=self.sample_tai_timestamp(idx),
            gimi_sample_content_id=self.sample_gimi_content_id(idx))

    def seek(self, idx: int) -> None:
        self._pos = max(0, min(idx, len(self.samples)))


class TrackVisual(Track):
    """Video track: frames decode on the track's device
    (ref: track_visual.cc:175 decode_next_image_sample)."""

    def __init__(self, trak: Box, file, sequence_timescale: int = 0,
                 sequence_duration: int = 0, device=None):
        super().__init__(trak, file, sequence_timescale, sequence_duration,
                         device)
        entry = None
        for c in self.stsd.children:
            if isinstance(c, VisualSampleEntry):
                entry = c
                break
        if entry is None:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "no visual sample entry")
        self.entry = entry
        self.width = entry.width
        self.height = entry.height
        self.coding = entry.box_type
        self.alpha_track: Optional["TrackVisual"] = None  # wired by context

    def sample_entry_type(self) -> str:
        return self.coding

    def auxiliary_info_type_urn(self) -> Optional[str]:
        """auxi box in the sample entry (aux tracks only)."""
        for c in self.entry.children:
            if c.box_type == "auxi":
                return c.aux_track_type
        return None

    def is_alpha_aux(self) -> bool:
        urn = self.auxiliary_info_type_urn()
        return urn in _ALPHA_AUX_URNS if urn else False

    def _config_box(self):
        for c in self.entry.children:
            if c.box_type in ("hvcC", "av1C", "avcC", "vvcC", "j2kH",
                              "jpgC"):
                return c
        return None

    def _decoder(self):
        """The registry's decoder of this track's coding, on the track's
        device (JAX track.py:477 looks it up without an id)."""
        fmt = _CODING_FORMATS.get(self.coding)
        if fmt is not None:
            return registry.decoder_for(fmt, None, self.device)
        name = _UNPORTED_CODINGS.get(self.coding)
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"{name} ('{self.coding}') tracks are not supported yet" if name
            else f"unknown track coding '{self.coding}'")

    def decode_sample(self, idx: int, limits=None):
        data = self.sample_data(idx)
        if self.coding == "uncv":
            # ISO 23001-17 uncompressed video sample entry
            # (ref: unc_boxes.h:494 Box_uncv): uncC/cmpd/cmpC/icef are
            # children of the sample entry, samples are raw frames
            from ..codecs.unc import UnciDecoder
            from ..boxes.unc import Box_uncC, Box_cmpd, Box_cmpC, Box_icef

            def child(cls):
                return next((c for c in self.entry.children
                             if isinstance(c, cls)), None)
            uncC = child(Box_uncC)
            if uncC is None:
                raise HeifError.invalid_input(
                    SubError.Unspecified, "uncv entry without uncC")
            dec = UnciDecoder(uncC, child(Box_cmpd), self.width, self.height,
                              cmpC=child(Box_cmpC), icef=child(Box_icef),
                              limits=limits, device=self.device)
            img = dec.decode(data)
        else:
            dec = self._decoder()
            if hasattr(dec, "start_sequence") and \
                    any(not s.is_sync for s in self.samples):
                # inter-coded track: stateful sequential decode with
                # sync-sample restarts (ref: track_visual.cc:175 + the
                # plugin's internal DPB)
                img = self._decode_sample_sequential(dec, idx, limits)
            else:
                img = dec.decode_single_image(self._config_box(), data,
                                              declared_size=(self.width,
                                                             self.height),
                                              limits=limits)
        img.duration = self.samples[idx].duration
        ts = self.sample_tai_timestamp(idx)
        if ts is not None:
            img.tai_timestamp = ts
        cid = self.sample_gimi_content_id(idx)
        if cid is not None:
            img.gimi_sample_content_id = cid
        return img

    def _decode_sample_sequential(self, dec, idx: int, limits=None):
        """Decode output frame idx through a persistent sequence
        session, restarting from the nearest preceding sync sample on
        random access (absent stss ⇒ every sample is sync).

        Samples are pushed in decode order; frames are pulled in
        output order, which differs for B-frame tracks (the session
        reorders by POC, ref: track_visual.cc:175 + the plugin DPB).
        One pushed sample may yield zero frames (reorder latency), so
        pushing and pulling are decoupled and the session is flushed
        when the sample list is exhausted."""
        session = getattr(self, "_seq_session", None)
        next_out = getattr(self, "_seq_out", 0)
        push_idx = getattr(self, "_seq_push", 0)
        if session is None or idx < next_out or \
                (idx > next_out and
                 any(self.samples[k].is_sync
                     for k in range(push_idx + 1,
                                    min(idx + 1, len(self.samples))))):
            # (re)start from the last sync sample at or before idx
            # (at sync points decode order == output order, so the
            # sample index is also the output index)
            start = min(idx, len(self.samples) - 1)
            while start > 0 and not self.samples[start].is_sync:
                start -= 1
            session = dec.start_sequence(self._config_box(), limits=limits)
            self._seq_session = session
            next_out = start
            push_idx = start
        img = None
        flushed = False
        while next_out <= idx:
            f = session.pull()
            if f is None:
                if push_idx < len(self.samples):
                    session.push_sample(self.sample_data(push_idx))
                    push_idx += 1
                    continue
                if not flushed:
                    session.flush()
                    flushed = True
                    continue
                raise HeifError.invalid_input(
                    msg=f"sequence decode produced no frame for "
                        f"sample {idx}")
            img = f
            next_out += 1
        self._seq_out = next_out
        self._seq_push = push_idx
        return img

    def decode_next_image(self, limits=None):
        """(ref: heif_track_decode_next_image; alpha merge
        track_visual.cc:295)."""
        if self._pos >= len(self.samples):
            return None
        idx = self._pos
        img = self.decode_sample(idx, limits)
        if self.alpha_track is not None and \
                idx < self.alpha_track.num_samples:
            from ..image.pixel_image import Channel
            alpha_img = self.alpha_track.decode_sample(idx, limits)
            if (alpha_img.width, alpha_img.height) != (img.width,
                                                       img.height):
                alpha_img = alpha_img.scale_nearest(img.width, img.height)
            if alpha_img.has_channel(Channel.Y) and \
                    not img.has_channel(Channel.Alpha):
                img.set_plane(Channel.Alpha, alpha_img.plane(Channel.Y),
                              alpha_img.bit_depth(Channel.Y))
        self._pos += 1
        return img


class TrackMetadata(Track):
    """URI metadata track (ref: track_metadata.{h,cc})."""

    def uri(self) -> str:
        for entry in self.stsd.children:
            if entry.box_type == "urim":
                return entry.get_uri()
        return ""

    def metadata_sample(self, idx: int) -> bytes:
        return self.sample_data(idx)


def interpret_tracks(file, device=None) -> List[Track]:
    """Build tracks from the file's moov box, decoding on ``device``
    (ref: HeifContext::interpret_heif_file_sequences context.cc:2044).

    Visual aux (alpha) tracks referenced via tref 'auxl' are wired to
    their master track, whose decode_next_image merges their alpha
    (ref: track_visual.cc:295).
    """
    device = resolve_device(device)
    moov = file.top_level_box("moov")
    if moov is None:
        return []
    mvhd = moov.get_child("mvhd")
    seq_timescale = mvhd.timescale if mvhd else 0
    seq_duration = mvhd.duration if mvhd else 0
    out: List[Track] = []
    for trak in moov.get_children("trak"):
        try:
            mdia = trak.get_child("mdia", required=True)
            hdlr = mdia.get_child("hdlr")
            handler = getattr(hdlr, "handler_type", "") if hdlr else ""
            cls = TrackVisual if handler in ("vide", "pict", "auxv") \
                else TrackMetadata
            out.append(cls(trak, file, seq_timescale, seq_duration, device))
        except HeifError:
            continue
    # wire alpha aux tracks to their masters
    by_id = {t.track_id: t for t in out}
    for t in out:
        if isinstance(t, TrackVisual) and t.is_alpha_aux():
            for master_id in t.references_of_type("auxl"):
                master = by_id.get(master_id)
                if isinstance(master, TrackVisual):
                    master.alpha_track = t
    return out


# ====================================================================== write

class SampleAuxInfoWriter:
    """Accumulates aux payloads, emitted as one block after the sample
    data (ref: track.cc:65 SampleAuxInfoHelper, write_all mode)."""

    def __init__(self, aux_info_type: str, parameter: int = 0):
        self.saiz = Box_saiz()
        self.saiz.set_aux_info_type(aux_info_type, parameter)
        self.saio = Box_saio()
        self.saio.set_aux_info_type(aux_info_type, parameter)
        self.blob = bytearray()

    def add_sample_info(self, data: bytes) -> None:
        if len(data) > 255:
            raise HeifError(ErrorCode.Encoding_error, SubError.Unspecified,
                            "sample aux info block too large")
        self.saiz.sample_sizes.append(len(data))
        self.blob += data

    def add_nonpresent_sample(self) -> None:
        self.saiz.sample_sizes.append(0)

    def finalize(self, file) -> Tuple[Box_saiz, Box_saio]:
        """Append the aux block to the mdat stream; the mdat-relative
        offset is made absolute at file write time (as stco's are).
        Idempotent, so repeated context writes give the same bytes."""
        if self.saio.offsets:
            return self.saiz, self.saio
        sizes = self.saiz.sample_sizes
        if sizes and all(s == sizes[0] for s in sizes) and sizes[0] != 0:
            self.saiz.default_sample_info_size = sizes[0]
            self.saiz.sample_count = len(sizes)
        self.saio.offsets = [file.append_sample_data(bytes(self.blob))]
        return self.saiz, self.saio


@dataclass
class TrackOptions:
    """heif_track_options equivalent (ref: track.h:95 TrackOptions)."""
    timescale: int = 90000
    interleaved_sample_aux_infos: bool = False
    with_tai_timestamps: int = 0        # 0=none 1=mandatory 2=optional
    tai_clock_info: Optional[TaiClockInfo] = None
    with_gimi_content_ids: int = 0
    gimi_track_content_id: str = ""
    # inter coding of an hevc track: "ipp", "ldb", "ibp" or "bpyr" (True
    # means "ipp"); False keeps all-intra tracks
    inter_frames: object = False


# sample entries of codecs the port does not write: JPEG 2000 (``j2ki``:
# the JAX package has no sequence encoder for it and reads no such track)
_UNPORTED_TRACK_FORMATS = {"j2k": "JPEG 2000"}


def _runs(values: List[int]) -> List[Tuple[int, int]]:
    """(count, value) runs of ``values`` (the stts/ctts entries)."""
    out: List[Tuple[int, int]] = []
    for v in values:
        if out and out[-1][1] == v:
            out[-1] = (out[-1][0] + 1, v)
        else:
            out.append((1, v))
    return out


class VisualTrackWriter:
    """Appends encoded frames as track samples (ref: Track_Visual encode
    path track_visual.cc:478, Track::write_sample_data track.cc:953).
    Frames are encoded on ``device`` (``None`` means CUDA): a frame
    lying elsewhere is copied there first, and an inter track's encoder
    decodes its references there."""

    def __init__(self, file, width: int, height: int, fmt: str = "hevc",
                 timescale: int = 90000, track_id: int = 1,
                 options: Optional[TrackOptions] = None,
                 handler: str = "vide",
                 aux_type_urn: Optional[str] = None, device=None):
        if fmt in _UNPORTED_TRACK_FORMATS:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                f"{_UNPORTED_TRACK_FORMATS[fmt]} ({fmt!r}) tracks are not "
                "supported by the port yet")
        self.file = file
        self.width = width
        self.height = height
        self.fmt = fmt
        self.device = resolve_device(device)
        self.sample_entry_type = {"hevc": "hvc1", "av1": "av01",
                                  "avc": "avc1", "vvc": "vvc1",
                                  "jpeg": "mjpg",
                                  "unc": "uncv", "uncv": "uncv"}.get(
                                      fmt, "hvc1")
        self.options = options or TrackOptions(timescale=timescale)
        if timescale != 90000:
            self.options.timescale = timescale
        self.timescale = self.options.timescale
        self.track_id = track_id
        self.handler = handler
        self.aux_type_urn = aux_type_urn
        self.sample_sizes: List[int] = []
        self.sample_offsets: List[int] = []
        self.sample_durations: List[int] = []
        self.cts_offsets: List[int] = []     # signed, ctts v1 (B frames)
        self.sync_samples: List[int] = []
        self.config_box = None
        self.track_references: List[Tuple[str, List[int]]] = []
        self.tai_writer = (SampleAuxInfoWriter("stai")
                           if self.options.with_tai_timestamps else None)
        self.gimi_writer = (SampleAuxInfoWriter("suid")
                            if self.options.with_gimi_content_ids else None)
        # A reorder-aware encode session emits samples of other display
        # frames (or none) on each push: each display frame's aux data
        # waits here and lands on its sample by display index (= decode
        # index + cts offset).
        self._seq_aux: Dict[int, Tuple[Optional[TaiTimestampPacket],
                                       Optional[str]]] = {}
        self._seq_pushed = 0
        self._seq_emitted = 0
        self._enc_session = None
        self._last_duration = 1

    def add_reference_to_track(self, ref_type: str,
                               to_track_id: int) -> None:
        for rt, ids in self.track_references:
            if rt == ref_type:
                ids.append(to_track_id)
                return
        self.track_references.append((ref_type, [to_track_id]))

    def add_frame(self, img, duration: int, options=None,
                  tai: Optional[TaiTimestampPacket] = None,
                  gimi_content_id: Optional[str] = None) -> None:
        """Encode ``img`` (a PixelImage) as the next display frame."""
        if duration == 0:
            raise HeifError.usage(msg="Sample duration may not be 0")
        if tai is None:
            tai = getattr(img, "tai_timestamp", None)
        if gimi_content_id is None:
            gimi_content_id = getattr(img, "gimi_sample_content_id", None)
        img = image_on_device(img, self.device)
        with trace.span("track.write"):
            if self.sample_entry_type == "uncv":
                # uncompressed video track (ref: Box_uncv unc_boxes.h:494):
                # raw 23001-17 frames, uncC/cmpd as sample-entry children
                data, cmpd, uncC, cmpC, icef = UnciEncoder().encode(img)
                if cmpC is not None or icef is not None:
                    raise HeifError.usage(
                        msg="generic compression unsupported for uncv "
                            "tracks")
                if self.config_box is None:
                    self.config_box = [cmpd, uncC]
            else:
                enc = registry.get_encoder(self.fmt)
                if enc is None:
                    raise HeifError.unsupported(
                        SubError.Unsupported_codec,
                        f"no encoder available for format {self.fmt!r}")
                inter = self.options.inter_frames
                if inter and hasattr(enc, "start_sequence_encode"):
                    self._add_inter_frame(enc, img, duration, options, tai,
                                          gimi_content_id)
                    return
                data, cfg, _props = enc.encode_single_image(img, options)
                if self.config_box is None:
                    self.config_box = cfg
            self._append_sample(data, duration, tai, gimi_content_id)

    def _add_inter_frame(self, enc, img, duration, options, tai,
                         gimi_content_id) -> None:
        """An inter track's frame through its stateful sequence session
        (ref: track_visual.cc:478 feeding the plugin's GOP)."""
        inter = self.options.inter_frames
        if self._enc_session is None:
            self._enc_session = enc.start_sequence_encode(
                img.width, img.height, options,
                gop_struct=inter if isinstance(inter, str) else "ipp",
                device=self.device)
        self._last_duration = duration
        self._seq_aux[self._seq_pushed] = (tai, gimi_content_id)
        self._seq_pushed += 1
        self._append_session_samples(self._enc_session.push_frames(img),
                                     duration)

    def _append_session_samples(self, samples, duration: int) -> None:
        for data, cfg, is_sync, cts in samples:
            if self.config_box is None and cfg is not None:
                self.config_box = cfg
            s_tai, s_gimi = self._seq_aux.pop(self._seq_emitted + cts,
                                              (None, None))
            self._seq_emitted += 1
            self._append_sample(data, duration, s_tai, s_gimi,
                                is_sync=is_sync, cts_offset=cts * duration)

    def add_raw_sample(self, sample: RawSequenceSample) -> None:
        """(ref: heif_track_add_raw_sequence_sample)."""
        if sample.duration == 0:
            raise HeifError.usage(msg="Sample duration may not be 0")
        self._append_sample(sample.data, sample.duration,
                            sample.timestamp,
                            sample.gimi_sample_content_id,
                            is_sync=sample.is_sync)

    def _append_sample(self, data: bytes, duration: int,
                       tai: Optional[TaiTimestampPacket],
                       gimi_content_id: Optional[str],
                       is_sync: bool = True,
                       cts_offset: int = 0) -> None:
        self.sample_offsets.append(self.file.append_sample_data(data))
        self.sample_sizes.append(len(data))
        self.sample_durations.append(duration)
        self.cts_offsets.append(cts_offset)
        if is_sync:
            self.sync_samples.append(len(self.sample_sizes))
        if self.tai_writer is not None:
            if tai is not None:
                self.tai_writer.add_sample_info(tai.to_bytes())
            elif self.options.with_tai_timestamps == 2:
                self.tai_writer.add_nonpresent_sample()
            else:
                raise HeifError(ErrorCode.Encoding_error, SubError.Unspecified,
                                "Mandatory TAI timestamp missing")
        if self.gimi_writer is not None:
            if gimi_content_id is not None:
                self.gimi_writer.add_sample_info(
                    gimi_content_id.encode("utf-8") + b"\0")
            elif self.options.with_gimi_content_ids == 2:
                self.gimi_writer.add_nonpresent_sample()
            else:
                raise HeifError(ErrorCode.Encoding_error, SubError.Unspecified,
                                "Mandatory ContentID missing")

    def flush_encoder(self) -> None:
        """Drain a reorder-aware encode session's lookahead (the
        trailing P of an IBP GOP) into the sample table."""
        if self._enc_session is not None:
            self._append_session_samples(self._enc_session.flush_frames(),
                                         self._last_duration)

    def _build_track_meta(self) -> Box_meta:
        """Trak-level meta carrying the GIMI track content ID as a
        'uri ' item stored in idat (no offset patching needed)."""
        payload = self.options.gimi_track_content_id.encode("utf-8") + b"\0"
        meta = Box_meta()
        hdlr = Box_hdlr()
        hdlr.handler_type = "meta"
        infe = Box_infe()
        infe.item_id = 1
        infe.item_type = "uri "
        infe.item_uri_type = GIMI_TRACK_CONTENT_ID_URI
        iinf = Box_iinf()
        iinf.children.append(infe)
        pitm = Box_pitm()
        pitm.item_id = 1
        iloc = Box_iloc()
        item = IlocItem()
        item.item_id = 1
        item.construction_method = 1
        item.extents.append(IlocExtent(0, 0, len(payload)))
        iloc.items.append(item)
        iloc.version = 1
        meta.children.extend([hdlr, pitm, iinf, iloc, Box_idat(payload)])
        return meta

    def _sample_entry(self) -> Box:
        entry = VisualSampleEntry(self.sample_entry_type)
        entry.width = self.width
        entry.height = self.height
        if self.config_box is not None:
            if isinstance(self.config_box, list):
                entry.children.extend(self.config_box)
            else:
                entry.children.append(self.config_box)
        if self.aux_type_urn:
            entry.children.append(Box_auxi(self.aux_type_urn))
        if self.options.tai_clock_info is not None:
            entry.children.append(Box_taic(self.options.tai_clock_info))
        entry.children.append(Box_ccst())
        return entry

    def _sample_tables(self) -> List[Box]:
        """stts, ctts (signed, version 1, when a sample is reordered),
        stsc, stsz, stco, stss."""
        stts = Box_stts()
        stts.entries = _runs(self.sample_durations)
        boxes = [stts]
        if any(self.cts_offsets):
            ctts = Box_ctts()
            ctts.version = 1
            ctts.entries = _runs(self.cts_offsets)
            boxes.append(ctts)
        boxes += self._chunk_tables()
        stss = Box_stss()
        stss.samples = list(self.sync_samples)
        return boxes + [stss]

    def _chunk_tables(self) -> List[Box]:
        """stsc, stsz, stco: one chunk per sample, since tracks may
        interleave in the mdat."""
        stsc = Box_stsc()
        stsc.entries = [(1, 1, 1)]
        stsz = Box_stsz()
        stsz.sizes = list(self.sample_sizes)
        stco = Box_stco()
        stco.offsets = list(self.sample_offsets)
        return [stsc, stsz, stco]

    def finalize(self) -> Box:
        """Build the trak box tree."""
        with trace.span("track.write.finalize"):
            self.flush_encoder()
            tkhd = Box_tkhd()
            tkhd.width = self.width << 16
            tkhd.height = self.height << 16
            mhd = Box_vmhd() if self.handler in ("vide", "pict", "auxv") \
                else Box_nmhd()
            return self._trak(tkhd, mhd, self.handler, "libheif_tpu video",
                              self._sample_entry(), self._sample_tables())

    def _trak(self, tkhd, mhd, handler: str, name: str, entry: Box,
              tables: List[Box]) -> Box:
        """tkhd, mdia (mdhd, hdlr, minf: ``mhd``, dinf, stbl: stsd holding
        ``entry``, ``tables`` and the aux info), tref and the GIMI
        meta."""
        duration = sum(self.sample_durations)
        tkhd.track_id = self.track_id
        tkhd.duration = duration
        mdhd = Box_mdhd()
        mdhd.timescale = self.timescale
        mdhd.duration = duration
        hdlr = Box_hdlr()
        hdlr.handler_type = handler
        hdlr.name = name
        dref = Box_dref()
        dref.children.append(Box_url())
        dinf = Box_dinf()
        dinf.children.append(dref)
        stsd = Box_stsd()
        stsd.children.append(entry)
        stbl = Box_stbl()
        stbl.children.extend([stsd] + tables)
        for writer in (self.tai_writer, self.gimi_writer):
            if writer is not None and writer.saiz.sample_sizes:
                stbl.children.extend(writer.finalize(self.file))
        minf = Box_minf()
        minf.children.extend([mhd, dinf, stbl])
        mdia = Box_mdia()
        mdia.children.extend([mdhd, hdlr, minf])
        trak = Box_trak()
        trak.children.extend([tkhd, mdia])
        if self.track_references:
            tref = Box_tref()
            for ref_type, ids in self.track_references:
                tref.add_references(ref_type, ids)
            trak.children.append(tref)
        if self.options.gimi_track_content_id:
            trak.children.append(self._build_track_meta())
        return trak


class MetadataTrackWriter(VisualTrackWriter):
    """URI metadata track writer
    (ref: heif_context_add_uri_metadata_sequence_track)."""

    def __init__(self, file, uri: str, timescale: int = 90000,
                 track_id: int = 1,
                 options: Optional[TrackOptions] = None, device=None):
        super().__init__(file, 0, 0, fmt="urim", timescale=timescale,
                         track_id=track_id, options=options,
                         handler="meta", device=device)
        self.uri_value = uri

    def add_metadata_sample(self, data: bytes, duration: int,
                            tai: Optional[TaiTimestampPacket] = None,
                            gimi_content_id: Optional[str] = None) -> None:
        if duration == 0:
            raise HeifError.usage(msg="Sample duration may not be 0")
        self._append_sample(data, duration, tai, gimi_content_id)

    def finalize(self) -> Box:
        with trace.span("track.write.finalize"):
            urim = Box_urim()
            urim.children.append(Box_uri(self.uri_value))
            stts = Box_stts()
            stts.entries = _runs(self.sample_durations)
            return self._trak(Box_tkhd(), Box_nmhd(), "meta",
                              "libheif_tpu metadata", urim,
                              [stts] + self._chunk_tables())
