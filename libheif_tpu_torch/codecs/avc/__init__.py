"""AVC (H.264): decode on the host (the C++ intra engine for CABAC intra
pictures, Python for CAVLC and P pictures), the planes brought to the
device in one copy; decoder.py.  The encoder is not ported yet."""

from .decoder import (AvcDecoder, AvcSequenceDecoder, AvcSequenceSession,
                      decode_annexb, decode_intra_frame)

__all__ = ["AvcDecoder", "AvcSequenceDecoder", "AvcSequenceSession",
           "decode_annexb", "decode_intra_frame"]
