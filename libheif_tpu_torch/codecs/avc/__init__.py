"""AVC (H.264): decode on the host (the C++ intra engine for CABAC intra
pictures, Python for CAVLC and P pictures), the planes brought to the
device in one copy; decoder.py.  The encoder (encoder.py: the C++ engine
for a still, Python for a sequence's IDR and P pictures) runs on the
host after one copy of the planes from the device.  Importing the package
registers the decoder (``tpu-avc``, JAX decoder.py:225) and the encoder,
as libheif_tpu/codecs/avc/__init__.py:14-15 does."""

from .decoder import (AvcDecoder, AvcSequenceDecoder, AvcSequenceSession,
                      decode_annexb, decode_intra_frame)
from .encoder import (AvcEncoder, AvcSequenceEncodeSession, encode_annexb,
                      encode_frame, register)
from ..registry import BuiltinDecoder, register_decoder

register_decoder(BuiltinDecoder("tpu-avc", "avc", AvcDecoder))
register()

__all__ = ["AvcDecoder", "AvcEncoder", "AvcSequenceDecoder",
           "AvcSequenceEncodeSession", "AvcSequenceSession",
           "decode_annexb", "decode_intra_frame", "encode_annexb",
           "encode_frame"]
