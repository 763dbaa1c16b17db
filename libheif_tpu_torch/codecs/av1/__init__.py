"""AV1 (av01): still-image decode (the OBU and tile parse on the host, the
reconstruction and the in-loop filters on the device: device_recon,
kernels in cuda_fast) and the still-image encoder (encoder.py, on the
host), which importing the package registers, as
libheif_tpu/codecs/av1/__init__.py:18 does."""

from .decoder import Av1Decoder, decode_intra_frame
from .encoder import Av1EncParams, Av1Encoder, Av1IntraEncoder, register_enc

register_enc()

__all__ = ["Av1Decoder", "decode_intra_frame", "Av1EncParams", "Av1Encoder",
           "Av1IntraEncoder"]
