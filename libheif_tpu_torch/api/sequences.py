"""Sequence/track API (ref: api/libheif/heif_sequences.h, 62 fns).

Tracks are the runtime objects from
:mod:`libheif_tpu_torch.sequences.track`; handles are the objects
themselves (no opaque pointers).  Function names and semantics mirror
the reference C API one-to-one; counterpart of
libheif_tpu/api/sequences.py.  A track decodes on its context's device
(``heif_track_decode_next_image`` ignores ``colorspace`` and ``chroma``,
as in JAX: the frame comes in its coded colorspace), and a visual track
writer encodes the frames it is given on theirs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..boxes.meta import TaiClockInfo, TaiTimestampPacket
from ..sequences.track import (RawSequenceSample, Track, TrackMetadata,
                               TrackOptions, TrackVisual,
                               MetadataTrackWriter, VisualTrackWriter)

heif_track_options = TrackOptions
heif_raw_sequence_sample = RawSequenceSample

# heif_auxiliary_track_info_type values
heif_auxiliary_track_info_type_alpha = 1
heif_auxiliary_track_info_type_depth = 2
heif_auxiliary_track_info_type_unknown = 0

# heif_sample_aux_info_presence
heif_sample_aux_info_presence_none = 0
heif_sample_aux_info_presence_mandatory = 1
heif_sample_aux_info_presence_optional = 2


# --------------------------------------------------------------- context

def heif_context_has_sequence(ctx) -> bool:
    return ctx.has_sequence()


def heif_context_get_sequence_timescale(ctx) -> int:
    return ctx.sequence_timescale()


def heif_context_get_sequence_duration(ctx) -> int:
    return ctx.sequence_duration()


def heif_context_number_of_sequence_tracks(ctx) -> int:
    return len(ctx.tracks)


def heif_context_get_track_ids(ctx) -> List[int]:
    return [t.track_id for t in ctx.tracks]


def heif_context_get_track(ctx, track_id: int):
    """track_id 0 = the first visual track (ref: heif_sequences.h)."""
    if track_id == 0:
        for t in ctx.tracks:
            if isinstance(t, TrackVisual):
                return t
        return ctx.tracks[0] if ctx.tracks else None
    return ctx.get_track(track_id)


def heif_context_set_sequence_timescale(ctx, timescale: int) -> None:
    ctx.set_sequence_timescale(timescale)


def heif_context_set_number_of_sequence_repetitions(ctx,
                                                    repetitions: int) -> None:
    ctx.set_number_of_sequence_repetitions(repetitions)


# ----------------------------------------------------------------- track

def heif_track_release(track) -> None:
    pass


def heif_track_get_id(track) -> int:
    return track.track_id


def heif_track_get_track_handler_type(track) -> str:
    return track.handler


def heif_track_get_timescale(track) -> int:
    return track.timescale


def heif_track_get_number_of_repetitions(track) -> int:
    return track.num_repetitions


def heif_track_get_duration_in_media_units(track) -> int:
    return track.duration()


def heif_track_get_number_of_output_samples(track) -> int:
    reps = track.num_repetitions
    if reps in (0, 1):
        return track.num_samples
    if reps == 0xFFFFFFFF:
        return 0xFFFFFFFFFFFFFFFF
    return track.num_samples * reps


def heif_track_get_image_resolution(track) -> Tuple[int, int]:
    return track.width, track.height


def heif_track_get_auxiliary_info_type(track) -> int:
    urn = track.auxiliary_info_type_urn() \
        if isinstance(track, TrackVisual) else None
    if urn is None:
        return heif_auxiliary_track_info_type_unknown
    if "alpha" in urn or "auxid:1" in urn:
        return heif_auxiliary_track_info_type_alpha
    if "depth" in urn or "auxid:2" in urn:
        return heif_auxiliary_track_info_type_depth
    return heif_auxiliary_track_info_type_unknown


def heif_track_get_auxiliary_info_type_urn(track) -> Optional[str]:
    return track.auxiliary_info_type_urn() \
        if isinstance(track, TrackVisual) else None


def heif_track_has_alpha_channel(track) -> bool:
    return getattr(track, "alpha_track", None) is not None


def heif_track_get_sample_entry_type_of_first_cluster(track) -> str:
    return track.sample_entry_type() if isinstance(track, TrackVisual) \
        else ("urim" if isinstance(track, TrackMetadata) else "????")


def heif_track_get_urim_sample_entry_uri_of_first_cluster(track) -> str:
    return track.uri() if isinstance(track, TrackMetadata) else ""


# ----------------------------------------------------------- decode side

def heif_track_decode_next_image(track, colorspace=None, chroma=None,
                                 options=None):
    return track.decode_next_image()


def heif_image_get_duration(img) -> int:
    return getattr(img, "duration", 0)


def heif_image_set_duration(img, duration: int) -> None:
    img.duration = duration


def heif_track_get_next_raw_sequence_sample(track) -> Optional[
        RawSequenceSample]:
    return track.get_next_raw_sample()


# ---------------------------------------------------- raw sample handle

def heif_raw_sequence_sample_alloc() -> RawSequenceSample:
    return RawSequenceSample()


def heif_raw_sequence_sample_release(sample) -> None:
    pass


def heif_raw_sequence_sample_get_data(sample) -> bytes:
    return sample.data


def heif_raw_sequence_sample_get_data_size(sample) -> int:
    return len(sample.data)


def heif_raw_sequence_sample_get_duration(sample) -> int:
    return sample.duration


def heif_raw_sequence_sample_set_data(sample, data: bytes) -> None:
    sample.data = bytes(data)


def heif_raw_sequence_sample_set_duration(sample, duration: int) -> None:
    sample.duration = duration


def heif_raw_sequence_sample_has_tai_timestamp(sample) -> bool:
    return sample.timestamp is not None


def heif_raw_sequence_sample_get_tai_timestamp(sample) -> Optional[
        TaiTimestampPacket]:
    return sample.timestamp


def heif_raw_sequence_sample_set_tai_timestamp(sample, timestamp) -> None:
    sample.timestamp = timestamp


def heif_raw_sequence_sample_get_gimi_sample_content_id(sample) -> Optional[str]:
    return sample.gimi_sample_content_id


def heif_raw_sequence_sample_set_gimi_sample_content_id(sample,
                                                        content_id) -> None:
    sample.gimi_sample_content_id = content_id


# -------------------------------------------------------- track options

def heif_track_options_alloc() -> TrackOptions:
    return TrackOptions()


def heif_track_options_release(options) -> None:
    pass


def heif_track_options_set_timescale(options, timescale: int) -> None:
    options.timescale = timescale


def heif_track_options_set_interleaved_sample_aux_infos(
        options, interleaved: bool) -> None:
    options.interleaved_sample_aux_infos = interleaved


def heif_track_options_set_gop_structure(options, gop: str) -> None:
    """Inter coding structure for visual tracks: "intra" (default),
    "ipp" (IPPP), "ldb" (low-delay B), "ibp" (reordered), "bpyr"
    (hierarchical B pyramid).  Extension over the reference API, which
    delegates GOP choice to the codec plugin."""
    if gop in ("", "intra", None):
        options.inter_frames = False
    elif gop in ("ipp", "ldb", "ibp", "bpyr"):
        options.inter_frames = gop
    else:
        from ..core.error import HeifError
        raise HeifError.usage(msg=f"unknown GOP structure '{gop}'")


def heif_track_options_enable_sample_tai_timestamps(
        options, clock_info, presence: int) -> None:
    options.with_tai_timestamps = presence
    options.tai_clock_info = clock_info


def heif_track_options_enable_sample_gimi_content_ids(
        options, presence: int) -> None:
    options.with_gimi_content_ids = presence


def heif_track_options_set_gimi_track_id(options, content_id: str) -> None:
    options.gimi_track_content_id = content_id


class heif_sequence_encoding_options:
    """(ref: heif_sequence_encoding_options_alloc)."""

    def __init__(self):
        self.output_nclx_profile = None
        self.color_conversion_options = None


def heif_sequence_encoding_options_alloc() -> heif_sequence_encoding_options:
    return heif_sequence_encoding_options()


def heif_sequence_encoding_options_copy(options):
    out = heif_sequence_encoding_options()
    out.output_nclx_profile = options.output_nclx_profile
    out.color_conversion_options = options.color_conversion_options
    return out


def heif_sequence_encoding_options_release(options) -> None:
    pass


# ----------------------------------------------------------- encode side

def heif_context_add_visual_sequence_track(ctx, width: int, height: int,
                                           track_type: str = "vide",
                                           fmt: str = "hevc",
                                           options: Optional[TrackOptions]
                                           = None) -> VisualTrackWriter:
    return ctx.add_visual_track(width, height, fmt=fmt, options=options,
                                handler=track_type)


def heif_context_add_uri_metadata_sequence_track(
        ctx, uri: str,
        options: Optional[TrackOptions] = None) -> MetadataTrackWriter:
    return ctx.add_uri_metadata_track(uri, options=options)


def heif_track_encode_sequence_image(track_writer, image, encoder=None,
                                     sequence_encoding_options=None) -> None:
    duration = getattr(image, "duration", 1)
    track_writer.add_frame(image, duration)


def heif_track_encode_end_of_sequence(track_writer) -> None:
    pass


def heif_track_add_raw_sequence_sample(track_writer, sample) -> None:
    track_writer.add_raw_sample(sample)


# ------------------------------------------------------- sample aux info

def heif_track_get_number_of_sample_aux_infos(track) -> int:
    return len(track.aux_readers)


def heif_track_get_sample_aux_info_types(track) -> List[Tuple[str, int]]:
    return track.sample_aux_info_types()


def heif_track_get_gimi_track_content_id(track) -> Optional[str]:
    return track.gimi_track_content_id()


def heif_image_get_gimi_sample_content_id(img) -> Optional[str]:
    return getattr(img, "gimi_sample_content_id", None)


def heif_image_set_gimi_sample_content_id(img, content_id) -> None:
    img.gimi_sample_content_id = content_id


def heif_track_get_tai_clock_info_of_first_cluster(track) -> Optional[
        TaiClockInfo]:
    return track.tai_clock_info()


# ------------------------------------------------------ track references

def heif_track_add_reference_to_track(track_writer, reference_type: str,
                                      to_track_id: int) -> None:
    track_writer.add_reference_to_track(reference_type, to_track_id)


def heif_track_get_number_of_track_reference_types(track) -> int:
    return len(track.reference_types())


def heif_track_get_track_reference_types(track) -> List[str]:
    return track.reference_types()


def heif_track_get_number_of_track_reference_of_type(track,
                                                     ref_type: str) -> int:
    return len(track.references_of_type(ref_type))


def heif_track_get_references_from_track(track, ref_type: str) -> List[int]:
    return track.references_of_type(ref_type)


def heif_track_find_referring_tracks(ctx, track, ref_type: str) -> List[int]:
    """Reverse reference lookup (ref: heif_track_find_referring_tracks)."""
    out = []
    for other in ctx.tracks:
        if track.track_id in other.references_of_type(ref_type):
            out.append(other.track_id)
    return out
