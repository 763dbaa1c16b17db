"""AVC (H.264): decode on the host (the C++ intra engine for CABAC intra
pictures, Python for CAVLC and P pictures), the planes brought to the
device in one copy; decoder.py.  The encoder (encoder.py: the C++ engine
for a still, Python for a sequence's IDR and P pictures) runs on the
host after one copy of the planes from the device; importing the package
registers it, as libheif_tpu/codecs/avc/__init__.py:15 does."""

from .decoder import (AvcDecoder, AvcSequenceDecoder, AvcSequenceSession,
                      decode_annexb, decode_intra_frame)
from .encoder import (AvcEncoder, AvcSequenceEncodeSession, encode_annexb,
                      encode_frame, register)

register()

__all__ = ["AvcDecoder", "AvcEncoder", "AvcSequenceDecoder",
           "AvcSequenceEncodeSession", "AvcSequenceSession",
           "decode_annexb", "decode_intra_frame", "encode_annexb",
           "encode_frame"]
