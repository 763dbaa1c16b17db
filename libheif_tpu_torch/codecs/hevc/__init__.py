"""HEVC (hvc1): decode of stills and sequences, and the still-image
encoder.  Intra pictures parse in the C++ parser, P and B pictures in the
Python slice parser, on the host; the reconstruction runs on the device
(device_recon, kernels in cuda_fast).  The encoder (encoder.py) runs on
the host, its mode search with ``mode="device"`` on the device; importing
the package registers it, as libheif_tpu/codecs/hevc/__init__.py:16
does."""

from .decoder import (HevcDecoder, HevcSequenceSession, SequenceDecoder,
                      decode_intra_picture)
from .encoder import EncParams, HevcEncoder, IntraEncoder, register

register()

__all__ = ["HevcDecoder", "HevcSequenceSession", "SequenceDecoder",
           "decode_intra_picture", "EncParams", "HevcEncoder",
           "IntraEncoder"]
