"""AV1 (av01): still-image decode (the OBU and tile parse on the host, the
reconstruction and the in-loop filters on the device: device_recon,
kernels in cuda_fast) and the still-image encoder (encoder.py, on the
host).  Importing the package registers the decoder (``tpu-av1``, JAX
decoder.py:164) and the encoder, as libheif_tpu/codecs/av1/__init__.py:
17-18 does."""

from .decoder import Av1Decoder, decode_intra_frame
from .encoder import Av1EncParams, Av1Encoder, Av1IntraEncoder, register_enc
from ..registry import BuiltinDecoder, register_decoder

register_decoder(BuiltinDecoder("tpu-av1", "av1", Av1Decoder))
register_enc()

__all__ = ["Av1Decoder", "decode_intra_frame", "Av1EncParams", "Av1Encoder",
           "Av1IntraEncoder"]
