"""Image sequences, read side: tracks and their sample tables
(counterpart of libheif_tpu/sequences)."""

from .track import (Sample, RawSequenceSample, SampleAuxInfoReader, Track,
                    TrackVisual, TrackMetadata, interpret_tracks)

__all__ = ["Sample", "RawSequenceSample", "SampleAuxInfoReader", "Track",
           "TrackVisual", "TrackMetadata", "interpret_tracks"]
