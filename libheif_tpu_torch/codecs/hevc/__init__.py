"""HEVC (hvc1) decode: stills and sequences.  Intra pictures parse in the
C++ parser, P and B pictures in the Python slice parser, on the host; the
reconstruction runs on the device (device_recon, kernels in cuda_fast)."""

from .decoder import (HevcDecoder, HevcSequenceSession, SequenceDecoder,
                      decode_intra_picture)

__all__ = ["HevcDecoder", "HevcSequenceSession", "SequenceDecoder",
           "decode_intra_picture"]
