"""VVC (H.266): the intra-only codec pair of the JAX package
(libheif_tpu/codecs/vvc), decode and encode on the host, the planes
moved between the host and the device in one copy each way
(decoder.py, encoder.py).  Importing the package registers the
decoder (``tpu-vvc``, JAX decoder.py:55) and the encoder, as
libheif_tpu/codecs/vvc/__init__.py:12-16 does."""

from .decoder import VvcDecoder, decode_intra_picture
from .encoder import EncParams, VvcEncoder, VvcIntraEncoder, register
from ..registry import BuiltinDecoder, register_decoder

register_decoder(BuiltinDecoder("tpu-vvc", "vvc", VvcDecoder))
register()

__all__ = ["EncParams", "VvcDecoder", "VvcEncoder", "VvcIntraEncoder",
           "decode_intra_picture"]
