"""Image sequences: tracks and their sample tables, and the track writers
(counterpart of libheif_tpu/sequences)."""

from .track import (Sample, RawSequenceSample, SampleAuxInfoReader,
                    SampleAuxInfoWriter, Track, TrackVisual, TrackMetadata,
                    TrackOptions, VisualTrackWriter, MetadataTrackWriter,
                    interpret_tracks)

__all__ = ["Sample", "RawSequenceSample", "SampleAuxInfoReader",
           "SampleAuxInfoWriter", "Track", "TrackVisual", "TrackMetadata",
           "TrackOptions", "VisualTrackWriter", "MetadataTrackWriter",
           "interpret_tracks"]
