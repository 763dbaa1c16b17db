"""JPEG (jpeg): decode (the marker parse and the Huffman scan on the host,
the dequantisation and IDCT on the device) and encode (the forward DCT and
quantiser on the device, the Huffman scan on the host); kernels in
cuda_fast.  Importing the package registers the decoder (``tpu-jpeg``,
libheif_tpu/codecs/jpeg/decoder.py:698) and the encoder."""

from .decoder import JpegDecoder, decode_jpeg
from .encoder import JpegEncoder, encode_jpeg
from ..registry import BuiltinDecoder, register_decoder

register_decoder(BuiltinDecoder("tpu-jpeg", "jpeg", JpegDecoder))

__all__ = ["JpegDecoder", "decode_jpeg", "JpegEncoder", "encode_jpeg"]
