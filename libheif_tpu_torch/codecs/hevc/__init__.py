"""HEVC (hvc1): decode of stills and sequences, and the still-image
encoder.  Intra pictures parse in the C++ parser, P and B pictures in the
Python slice parser, on the host; the reconstruction runs on the device
(device_recon, kernels in cuda_fast).  The encoder (encoder.py) runs on
the host, its mode search with ``mode="device"`` on the device.  Importing
the package registers the decoder (``tpu-hevc``, JAX decoder.py:444) and
the encoder, as libheif_tpu/codecs/hevc/__init__.py:15-16 does."""

from .decoder import (HevcDecoder, HevcSequenceSession, SequenceDecoder,
                      decode_intra_picture)
from .encoder import EncParams, HevcEncoder, IntraEncoder, register
from ..registry import BuiltinDecoder, register_decoder

register_decoder(BuiltinDecoder("tpu-hevc", "hevc", HevcDecoder))
register()

__all__ = ["HevcDecoder", "HevcSequenceSession", "SequenceDecoder",
           "decode_intra_picture", "EncParams", "HevcEncoder",
           "IntraEncoder"]
